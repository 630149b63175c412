"""Attention dispatch: the CUDA kernels for tensors on the card, the plain
versions for tensors on the CPU."""
from __future__ import annotations

import torch

from repro_torch.kernels import dtensor
from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention,
    flash_attention_bwd,
)
from repro_torch.kernels.flash_attention.paged_attention import paged_attention
from repro_torch.kernels.flash_attention.ref import attention_ref, paged_attention_ref


class FlashAttention(torch.autograd.Function):
    """The flash kernel with its backward kernel, for CUDA tensors under grad.

    The forward also writes each row's log-sum-exp and saves q, k, v, o and
    lse; the backward is ``flash_attention_bwd``. Under
    ``torch.utils.checkpoint`` the forward runs twice (the saving pass and
    the recompute before the backward)."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if do.stride(3) != 1:
            do = do.contiguous()
        # k and v without a gradient (cross-attention over a fixed memory):
        # the dq pass alone
        dkdv = ctx.needs_input_grad[1] or ctx.needs_input_grad[2]
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, causal=ctx.causal, dkdv=dkdv)
        return dq, dk, dv, None


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool = True) -> torch.Tensor:
    """q: (B, L, H, hd); k, v: (B, L, KV, hd) — model layout, returned as q.

    On the card: the kernel, through ``FlashAttention`` (forward with
    log-sum-exp, backward kernel) where autograd needs the gradient of an
    input, otherwise one plain forward launch. On the CPU: the plain version,
    which autograd differentiates. A DTensor call runs on each rank's local
    shard: the batch over the data axes, the heads over ``model`` where both
    head counts divide it (``kernels.dtensor.local_call``)."""
    if type(q) is not torch.Tensor and dtensor.any_dtensor(q, k, v):
        return dtensor.local_call(lambda q, k, v: attend(q, k, v, causal=causal), (q, k, v),
                                  batch_dims=(0, 0, 0), head_dims=(2, 2, 2),
                                  out_batch_dim=0, out_head_dim=2)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if not q.is_cuda:
        out = attention_ref(qt, kt, vt, causal=causal)
    elif torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                      or v.requires_grad):
        out = FlashAttention.apply(qt, kt, vt, causal)
    else:
        out = flash_attention(qt, kt, vt, causal=causal)
    return out.transpose(1, 2)


def paged_attend(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                 block_table: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """One-token paged decode attention; q: (B, KV, G, hd) grouped heads,
    k_pages/v_pages: (num_pages, page_size, KV, hd), block_table: (B, nb),
    lengths: (B,), both int32. A DTensor call runs on each rank's local
    shard: the batch (q, the table, the lengths) over the data axes, the KV
    heads over ``model`` where they divide it."""
    if type(q) is not torch.Tensor and dtensor.any_dtensor(q, k_pages, v_pages):
        return dtensor.local_call(paged_attend, (q, k_pages, v_pages, block_table, lengths),
                                  batch_dims=(0, None, None, 0, 0),
                                  head_dims=(1, 2, 2, None, None),
                                  out_batch_dim=0, out_head_dim=1)
    if q.is_cuda:
        return paged_attention(q, k_pages, v_pages, block_table, lengths)
    return paged_attention_ref(q, k_pages, v_pages, block_table, lengths)
