"""Dispatch for the NS update: the CUDA kernels for tensors on the card, the
plain versions for tensors on the CPU. ``make_update_fn`` plugs into
``ns_solver.ns_sample(update_fn=...)``."""
from __future__ import annotations

import torch

from repro_torch.kernels import dtensor
from repro_torch.kernels.ns_update.ns_update import ns_update, ns_update_bwd
from repro_torch.kernels.ns_update.ref import ns_update_bwd_ref, ns_update_ref


class NSUpdate(torch.autograd.Function):
    """``a * x0 + sum_j w_j u_j`` with a backward: the kernels on the card, the
    plain versions on the CPU (chosen by where x0 lies)."""

    @staticmethod
    def forward(ctx, x0, u, a, w):
        ctx.save_for_backward(x0, u, a, w)
        return ns_update(x0, u, a, w) if x0.is_cuda else ns_update_ref(x0, u, a, w)

    @staticmethod
    def backward(ctx, g):
        x0, u, a, w = ctx.saved_tensors
        bwd = ns_update_bwd if g.is_cuda else ns_update_bwd_ref
        return bwd(g.contiguous(), x0, u, a, w, need_x0=ctx.needs_input_grad[0])


def fused_ns_update(x0: torch.Tensor, u: torch.Tensor, a: torch.Tensor,
                    w: torch.Tensor) -> torch.Tensor:
    """``a * x0 + sum_j w_j u_j``. Where autograd needs the result's gradient
    it goes through ``NSUpdate``, whose backward is the backward kernel on the
    card; otherwise it is one call of the kernel (or the plain version on the
    CPU). A DTensor call runs on each rank's local shard, the batch split
    over the data axes (``kernels.dtensor.local_call``)."""
    if type(x0) is not torch.Tensor and dtensor.any_dtensor(x0, u, a, w):
        return dtensor.local_call(fused_ns_update, (x0, u, a, w), batch_dims=(0, 1, None, None),
                                  head_dims=(None,) * 4, out_batch_dim=0, out_head_dim=None)
    if torch.is_grad_enabled() and (x0.requires_grad or u.requires_grad
                                    or a.requires_grad or w.requires_grad):
        return NSUpdate.apply(x0, u, a, w)
    if x0.is_cuda:
        return ns_update(x0, u, a, w)
    return ns_update_ref(x0, u, a, w)


def make_update_fn():
    """The ``update_fn(x0, U, a_i, w_i)`` hook of ``ns_sample``."""
    return fused_ns_update
