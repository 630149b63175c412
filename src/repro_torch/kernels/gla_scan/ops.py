"""Dispatch for the gated linear recurrence: the CUDA kernels for tensors on
the card (``GLAScan`` under grad, with its backward kernel), the plain
chunked form (``models.linear_scan.gla_chunked``) for tensors on the CPU."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import dtensor
from repro_torch.kernels.gla_scan.gla_scan import gla_scan, gla_scan_bwd
from repro_torch.models.linear_scan import gla_chunked


def _heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """q and k over v's heads: one group (a head dim of 1) as stride-0 views."""
    B, L, H, _ = v.shape
    return q.expand(B, L, H, q.shape[-1]), k.expand(B, L, H, k.shape[-1])


class GLAScan(torch.autograd.Function):
    """The gla_scan kernel with its backward kernel, for CUDA tensors under
    grad. The forward saves its inputs only: the backward recomputes the
    chunks' starting states (``gla_scan_bwd``). q and k of one group
    ((B, L, 1, dk)) get gradients summed over the heads by the kernel. Under
    ``torch.utils.checkpoint`` the forward runs twice, as any layer's does."""

    @staticmethod
    def forward(ctx, q, k, v, ld, s0, inclusive, chunk):
        o, S = gla_scan(*_heads(q, k, v), v, ld, s0, inclusive=inclusive, chunk=chunk)
        ctx.save_for_backward(q, k, v, ld, s0)
        ctx.inclusive, ctx.chunk = inclusive, chunk
        ctx.set_materialize_grads(False)
        return o, S

    @staticmethod
    def backward(ctx, do, dS):
        q, k, v, ld, s0 = ctx.saved_tensors
        if do is None:                    # only the final state reaches the loss
            do = torch.zeros_like(v)
        dq, dk, dv, dld, ds0 = gla_scan_bwd(q, k, v, ld, s0, do, dS,
                                            inclusive=ctx.inclusive, chunk=ctx.chunk)
        return dq, dk, dv, dld, ds0, None, None


def gla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, ld: torch.Tensor,
        s0: Optional[torch.Tensor] = None, *, inclusive: bool = True,
        chunk: int = 64) -> tuple[torch.Tensor, torch.Tensor]:
    """q, k: (B, L, H, dk), or (B, L, 1, dk) for one group broadcast over
    v's heads; ld: (B, L, H, dk) or (B, L, H, 1); v: (B, L, H, dv); s0: None
    or (B, H, dk, dv). Returns (o in v's dtype, final state f32).

    On the card, inputs that require grad under grad mode go through
    ``GLAScan`` (forward and backward kernels), the rest through one forward
    launch; on the CPU, the plain chunked form, which autograd
    differentiates. A DTensor call runs on each rank's local shards: the
    batch over the data axes, the heads over ``model`` where they divide it
    (``kernels.dtensor.local_call``; one group of q and k is replicated
    along it)."""
    if type(v) is not torch.Tensor and dtensor.any_dtensor(q, k, v, ld, s0):
        def heads(x):
            return 2 if x.shape[2] == v.shape[2] else None

        return dtensor.local_call(
            lambda q, k, v, ld, s0: gla(q, k, v, ld, s0, inclusive=inclusive, chunk=chunk),
            (q, k, v, ld, s0), batch_dims=(0, 0, 0, 0, 0),
            head_dims=(heads(q), heads(k), 2, 2, 1), out_batch_dim=(0, 0),
            out_head_dim=(2, 1))
    if q.is_cuda:
        if torch.is_grad_enabled() and any(
                t is not None and t.requires_grad for t in (q, k, v, ld, s0)):
            return GLAScan.apply(q, k, v, ld, s0, inclusive, chunk)
        return gla_scan(*_heads(q, k, v), v, ld, s0, inclusive=inclusive, chunk=chunk)
    return gla_chunked(*_heads(q, k, v), v, ld, s0, inclusive=inclusive, chunk=chunk)
