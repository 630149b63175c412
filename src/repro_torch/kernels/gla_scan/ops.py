"""Dispatch for the gated linear recurrence: the CUDA kernel for tensors on
the card, the plain chunked form (``models.linear_scan.gla_chunked``) for
tensors on the CPU."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.gla_scan.gla_scan import gla_scan
from repro_torch.models.linear_scan import gla_chunked

# where the kernel's backward stands in ROADMAP.md
BACKWARD_ROADMAP = "ROADMAP Queue B item 6"


def gla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, ld: torch.Tensor,
        s0: Optional[torch.Tensor] = None, *, inclusive: bool = True,
        chunk: int = 64) -> tuple[torch.Tensor, torch.Tensor]:
    """q, k, ld: (B, L, H, dk) (ld's last dim may be 1); v: (B, L, H, dv);
    s0: None or (B, H, dk, dv). Returns (o in v's dtype, final state f32).

    The kernel's outputs have no ``grad_fn``: on the card, inputs that
    require grad under grad mode are refused rather than cut from the graph
    (the CPU's plain form is differentiable)."""
    if q.is_cuda:
        if torch.is_grad_enabled() and any(
                t is not None and t.requires_grad for t in (q, k, v, ld, s0)):
            raise RuntimeError(
                "gla: the CUDA gla_scan kernel has no backward yet "
                f"({BACKWARD_ROADMAP}); run under torch.no_grad() or with "
                "inputs that do not require grad")
        return gla_scan(q, k, v, ld, s0, inclusive=inclusive, chunk=chunk)
    return gla_chunked(q, k, v, ld, s0, inclusive=inclusive, chunk=chunk)
