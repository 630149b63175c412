"""Unified model API — the dense family and the paper's flow substrate.

Port of the dense branch of ``repro.models.model``:

  init_params(generator, cfg, device)        -> params tree
  velocity(params, cfg, t, x, batch)         -> u_t(x) over latent sequences
  velocity_field(params, cfg, sched, batch)  -> VelocityField (with CFG)

``batch`` is a dict: {"tokens": (B, S) long}. The other families raise
``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.parametrization import VelocityField
from repro_torch.core.schedulers import Scheduler
from repro_torch.models import transformer
from repro_torch.models.transformer import latent_targets

Tensor = torch.Tensor

FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")
PORTED_FAMILIES = ("dense",)

__all__ = ["FAMILIES", "PORTED_FAMILIES", "init_params", "velocity",
           "velocity_field", "latent_targets"]


def _require_ported(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"the {cfg.family!r} family is not ported yet (ROADMAP Queue A item 10)")


def init_params(generator: torch.Generator, cfg: ModelConfig, device="cuda") -> dict:
    _require_ported(cfg)
    return transformer.init_dense_params(generator, cfg, device)


def velocity(params: dict, cfg: ModelConfig, t, x: Tensor,
             batch: Optional[dict] = None) -> Tensor:
    """u_t(x): x (B, S, latent_dim) -> velocity. ``batch`` provides the
    conditioning tokens; None = unconditional (CFG)."""
    _require_ported(cfg)
    cond = batch.get("tokens") if batch else None
    return transformer.flow_velocity(params, cfg, t, x, cond)


def velocity_field(params: dict, cfg: ModelConfig, sched: Scheduler,
                   batch: Optional[dict] = None, *, cfg_scale: float = 0.0
                   ) -> VelocityField:
    """Wrap the model for the NS sampler, with classifier-free guidance."""

    def u(t, x):
        uc = velocity(params, cfg, t, x, batch)
        if cfg_scale == 0.0:
            return uc
        uu = velocity(params, cfg, t, x, None)
        return (1.0 + cfg_scale) * uc - cfg_scale * uu

    return VelocityField(fn=u, scheduler=sched)
