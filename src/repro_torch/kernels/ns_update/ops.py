"""Dispatch for the NS update: the CUDA kernel for tensors on the card, the
plain version for tensors on the CPU. ``make_update_fn`` plugs into
``ns_solver.ns_sample(update_fn=...)``."""
from __future__ import annotations

import torch

from repro_torch.kernels.ns_update.ns_update import ns_update
from repro_torch.kernels.ns_update.ref import ns_update_ref


def fused_ns_update(x0: torch.Tensor, u: torch.Tensor, a: torch.Tensor,
                    w: torch.Tensor) -> torch.Tensor:
    """``a * x0 + sum_j w_j u_j``. On the card the kernel's output has no
    ``grad_fn``, so inputs that require grad are refused there rather than
    cut from the graph."""
    if x0.is_cuda:
        if torch.is_grad_enabled() and (x0.requires_grad or u.requires_grad
                                        or a.requires_grad or w.requires_grad):
            raise RuntimeError(
                "fused_ns_update: the CUDA ns_update kernel has no backward yet "
                "(its torch.autograd.Function comes with ROADMAP Queue A item 0); "
                "sample under torch.no_grad() or with inputs that do not require grad")
        return ns_update(x0, u, a, w)
    return ns_update_ref(x0, u, a, w)


def make_update_fn():
    """The ``update_fn(x0, U, a_i, w_i)`` hook of ``ns_sample``."""
    return fused_ns_update
