"""Attention dispatch in the model's layout: the CUDA flash kernel for tensors
on the card, the plain version for tensors on the CPU."""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool = True) -> torch.Tensor:
    """q: (B, L, H, hd); k, v: (B, L, KV, hd) — model layout, returned as q."""
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if q.is_cuda:
        out = flash_attention(qt, kt, vt, causal=causal)
    else:
        out = attention_ref(qt, kt, vt, causal=causal)
    return out.transpose(1, 2)
