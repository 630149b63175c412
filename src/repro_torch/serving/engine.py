"""Serving engine: ``FlowSampler``, the paper's product.

Port of ``repro.serving.engine.FlowSampler``: batched sampling of a flow
model with an NS solver (Algorithm 1). Each request batch costs exactly
``n`` backbone forwards, and every solver step's update runs the
``ns_update`` kernel on the card (its plain version on the CPU).

``FlowSampler.from_artifact`` (ROADMAP Queue A item 3), ``AnytimeFlowSampler``
(item 4) and ``DecodeEngine`` with its sampling functions (item 9) come with
their slices.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import ns_solver
from repro_torch.core.ns_solver import NSParams
from repro_torch.core.schedulers import Scheduler
from repro_torch.models import model as M

Tensor = torch.Tensor


def nearest_budget(budgets, m: int, strict: bool = False) -> int:
    """The budget-routing rule: an exact match passes through; otherwise the
    nearest served budget (ties break to the smaller — fewer backbone
    forwards), or ``ValueError`` under ``strict``."""
    if m in budgets:
        return m
    if strict:
        raise ValueError(f"budget {m} not served; have {tuple(budgets)}")
    return min(budgets, key=lambda b: (abs(b - m), b))


def nearest_latent_tokens(params: dict, latents: Tensor) -> Tensor:
    """Decode sampled latents to tokens by nearest latent embedding."""
    table = params["flow"]["latent_embed"].to(torch.float32)
    lat = latents.to(torch.float32)
    d2 = (torch.sum(lat ** 2, -1, keepdim=True)
          - 2.0 * lat @ table.T
          + torch.sum(table ** 2, -1))
    return torch.argmin(d2, dim=-1)


@dataclasses.dataclass
class FlowSampler:
    """A fixed-NFE sampling session on the device that holds ``params``."""

    params: dict
    cfg: ModelConfig
    sched: Scheduler
    solver: NSParams
    cfg_scale: float = 0.0

    def __post_init__(self):
        self.device = self.params["final_norm"].device
        self.solver = self.solver.to(self.device)

    def _sample(self, batch: Optional[dict], x0: Tensor) -> Tensor:
        if batch is not None:
            batch = {k: v.to(self.device) for k, v in batch.items()}
        field = M.velocity_field(self.params, self.cfg, self.sched, batch,
                                 cfg_scale=self.cfg_scale)
        with torch.no_grad():
            return ns_solver.ns_sample(self.solver, field.fn, x0)

    # -- budget protocol: a fixed-NFE session serves exactly one budget. ----

    @property
    def budgets(self) -> tuple[int, ...]:
        return (self.solver.n,)

    def resolve_budget(self, m: int, strict: bool = False) -> int:
        """One served budget: exact match or (with ``strict``) rejection."""
        if m != self.solver.n and strict:
            raise ValueError(f"budget {m} not served; have {self.budgets}")
        return self.solver.n

    def sample_from(self, batch: Optional[dict], x0, budget: Optional[int] = None) -> Tensor:
        """Integrate given noise ``x0`` (a tensor or numpy array; this
        session's one budget)."""
        if budget is not None and budget != self.solver.n:
            raise ValueError(f"budget {budget} not served; have {self.budgets}")
        x0 = torch.as_tensor(x0, dtype=torch.float32).to(self.device)
        return self._sample(batch, x0)

    def sample(self, batch: dict, generator: torch.Generator) -> Tensor:
        """Generate latent sequences conditioned on ``batch`` tokens, from
        noise drawn with ``generator`` (which lives on the sampler's device).

        The latent length equals the conditioning token length — the backbone
        adds conditioning embeddings position-wise, so they cannot differ.
        """
        B, S = batch["tokens"].shape
        x0 = torch.randn((B, S, self.cfg.latent_dim), generator=generator,
                         dtype=torch.float32, device=self.device)
        return self._sample(batch, x0)

    def nearest_tokens(self, latents: Tensor) -> Tensor:
        """Decode sampled latents to tokens by nearest latent embedding."""
        return nearest_latent_tokens(self.params, latents)
