"""Unified model API — the dense family and the paper's flow substrate.

Port of the dense branch of ``repro.models.model``:

  init_params(generator, cfg, device)             -> params tree
  velocity(params, cfg, t, x, batch)              -> u_t(x) over latent sequences
  velocity_field(params, cfg, sched, batch)       -> VelocityField (with CFG)
  init_decode_state(cfg, batch, slots, ...)       -> KV cache
  init_paged_decode_state(cfg, batch, pages, ...) -> paged KV cache
  decode_apply(params, cfg, token, state)         -> (logits, state)

``batch`` is a dict: {"tokens": (B, S) long}. The other families raise
``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.parametrization import VelocityField
from repro_torch.core.schedulers import Scheduler
from repro_torch.models import transformer
from repro_torch.models.attention import KVCache, PagedKVCache
from repro_torch.models.transformer import latent_targets

Tensor = torch.Tensor

FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")
PORTED_FAMILIES = ("dense",)
PAGED_FAMILIES = ("dense", "moe", "vlm")   # KV-cache families that can page

__all__ = ["FAMILIES", "PORTED_FAMILIES", "PAGED_FAMILIES", "init_params", "velocity",
           "velocity_field", "latent_targets", "init_decode_state",
           "init_paged_decode_state", "decode_state_batch_axes", "decode_apply"]


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


# ---------------------------------------------------------------------------
# Decode: one token per call over a KV cache
# ---------------------------------------------------------------------------


def init_decode_state(cfg: ModelConfig, batch: int, slots: int, dtype=torch.bfloat16,
                      device="cuda"):
    _require_ported(cfg)
    return transformer.init_caches(cfg, batch, slots, dtype, resolve_device(device))


def init_paged_decode_state(cfg: ModelConfig, batch: int, num_pages: int,
                            page_size: int, blocks_per_slot: int,
                            dtype=torch.bfloat16, device="cuda"):
    """Paged decode state (``PagedKVCache``) for the KV-cache families."""
    if cfg.family not in PAGED_FAMILIES:
        raise TypeError(f"paged KV cache not supported for {cfg.family!r} "
                        f"(pageable families: {PAGED_FAMILIES})")
    _require_ported(cfg)
    return transformer.init_paged_caches(cfg, batch, num_pages, page_size,
                                         blocks_per_slot, dtype, resolve_device(device))


def decode_state_batch_axes(cfg: ModelConfig, paged: bool = False):
    """The BATCH axis of each state leaf (the axis indexed by sequence slot),
    in the state's own structure; slot serving resets rows through it.
    ``paged=True``: the page pool has no per-row axis and reads ``-1``; rows
    are isolated there by page ownership and the trash page, not by masks."""
    _require_ported(cfg)
    if paged:
        return PagedKVCache(k_pages=-1, v_pages=-1, block_table=0, index=0)
    return KVCache(k=1, v=1, index=0)


def decode_apply(params: dict, cfg: ModelConfig, token: Tensor, state, *,
                 window: int = 0, paged_kernel: bool = False,
                 active: Optional[Tensor] = None):
    """One decode step; ``state`` is updated in place (``transformer.decode_step``)."""
    _require_ported(cfg)
    return transformer.decode_step(params, cfg, token, state, window=window,
                                   paged_kernel=paged_kernel, active=active)
