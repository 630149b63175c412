"""Dispatch for the gated linear recurrence: the CUDA kernel for tensors on
the card, the plain chunked form (``models.linear_scan.gla_chunked``) for
tensors on the CPU."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.gla_scan.gla_scan import gla_scan
from repro_torch.models.linear_scan import gla_chunked


def gla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, ld: torch.Tensor,
        s0: Optional[torch.Tensor] = None, *, inclusive: bool = True,
        chunk: int = 64) -> tuple[torch.Tensor, torch.Tensor]:
    """q, k, ld: (B, L, H, dk) (ld's last dim may be 1); v: (B, L, H, dv);
    s0: None or (B, H, dk, dv). Returns (o in v's dtype, final state f32)."""
    if q.is_cuda:
        return gla_scan(q, k, v, ld, s0, inclusive=inclusive, chunk=chunk)
    return gla_chunked(q, k, v, ld, s0, inclusive=inclusive, chunk=chunk)
