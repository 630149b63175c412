"""Dispatch for the NS update: the CUDA kernel for tensors on the card, the
plain version for tensors on the CPU. ``make_update_fn`` plugs into
``ns_solver.ns_sample(update_fn=...)``."""
from __future__ import annotations

import torch

from repro_torch.kernels.ns_update.ns_update import ns_update
from repro_torch.kernels.ns_update.ref import ns_update_ref


def fused_ns_update(x0: torch.Tensor, u: torch.Tensor, a: torch.Tensor,
                    w: torch.Tensor) -> torch.Tensor:
    if x0.is_cuda:
        return ns_update(x0, u, a, w)
    return ns_update_ref(x0, u, a, w)


def make_update_fn():
    """The ``update_fn(x0, U, a_i, w_i)`` hook of ``ns_sample``."""
    return fused_ns_update
