"""Attention dispatch: the CUDA kernels for tensors on the card, the plain
versions for tensors on the CPU."""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.paged_attention import paged_attention
from repro_torch.kernels.flash_attention.ref import attention_ref, paged_attention_ref


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool = True) -> torch.Tensor:
    """q: (B, L, H, hd); k, v: (B, L, KV, hd) — model layout, returned as q."""
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if q.is_cuda:
        out = flash_attention(qt, kt, vt, causal=causal)
    else:
        out = attention_ref(qt, kt, vt, causal=causal)
    return out.transpose(1, 2)


def paged_attend(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                 block_table: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """One-token paged decode attention; q: (B, KV, G, hd) grouped heads,
    k_pages/v_pages: (num_pages, page_size, KV, hd), block_table: (B, nb),
    lengths: (B,), both int32."""
    if q.is_cuda:
        return paged_attention(q, k_pages, v_pages, block_table, lengths)
    return paged_attention_ref(q, k_pages, v_pages, block_table, lengths)
