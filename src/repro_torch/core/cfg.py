"""Classifier-free guidance over velocity fields (Ho & Salimans 2022).

Port of ``repro.core.cfg``. The guided field is  u_w = (1 + w) u_cond - w u_uncond
(w = 0 is the pure conditional model, matching the paper's 'unguided' w=0
convention). As the paper notes, CFG doubles the effective batch per NFE;
``guided_field_stacked`` stacks cond/uncond along the batch axis so the
backbone runs once.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.parametrization import VelocityField

Tensor = torch.Tensor


def guided_field(
    cond_fn: Callable[[Tensor, Tensor], Tensor],
    uncond_fn: Callable[[Tensor, Tensor], Tensor],
    w: float,
    scheduler,
) -> VelocityField:
    """Build u_w from separate conditional/unconditional evaluations."""

    def u(t: Tensor, x: Tensor) -> Tensor:
        if w == 0.0:
            return cond_fn(t, x)
        return (1.0 + w) * cond_fn(t, x) - w * uncond_fn(t, x)

    return VelocityField(fn=u, scheduler=scheduler)


def guided_field_stacked(
    model_fn: Callable[[Tensor, Tensor, Tensor], Tensor],
    cond: Tensor,
    null_cond: Tensor,
    w: float,
    scheduler,
) -> VelocityField:
    """CFG with a single stacked forward: model_fn(t, x2, cond2) on 2B batch."""

    def u(t: Tensor, x: Tensor) -> Tensor:
        if w == 0.0:
            return model_fn(t, x, cond)
        x2 = torch.cat([x, x], dim=0)
        c2 = torch.cat([cond, null_cond], dim=0)
        out = model_fn(t, x2, c2)
        uc, uu = torch.chunk(out, 2, dim=0)
        return (1.0 + w) * uc - w * uu

    return VelocityField(fn=u, scheduler=scheduler)
