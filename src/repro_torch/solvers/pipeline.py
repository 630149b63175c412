"""Sampling pipeline — thin sessions around Algorithm 1.

Port of ``repro.solvers.pipeline``. ``Sampler`` binds NS parameters to a
velocity field; the reference wraps the call in ``jax.jit``. The port's
compiled-program caches are the serving engines' CUDA graphs
(``serving.programs``: ``FlowSampler`` and ``AnytimeFlowSampler`` capture
one a budget, shape or leg); ``Sampler`` runs eagerly under
``torch.no_grad()`` on x0's device, since its field may be any callable,
such as the paper-claims twin's mixture field, whose host work a graph
cannot capture.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core import ns_solver
from repro_torch.core.bns import psnr
from repro_torch.core.ns_solver import NSParams
from repro_torch.core.parametrization import VelocityField

Tensor = torch.Tensor


class Sampler:
    """A sampling session: ``sampler(x0) -> x1`` at exactly n NFE.

    ``update_fn`` may override the weighted-sum update; the default is
    ``ns_sample``'s (the ``ns_update`` kernel on the card)."""

    def __init__(self, params: NSParams, field: VelocityField,
                 update_fn: Optional[Callable] = None):
        self.params = params
        self.field = field
        self.update_fn = update_fn

    @property
    def nfe(self) -> int:
        return self.params.n

    def __call__(self, x0: Tensor) -> Tensor:
        with torch.no_grad():
            return ns_solver.ns_sample(self.params, self.field.fn, x0,
                                       update_fn=self.update_fn)

    def psnr(self, pairs: tuple[Tensor, Tensor], max_val: float = 1.0) -> float:
        """Mean PSNR of this sampler against (x0, x1) reference pairs."""
        x0, x1 = pairs
        return float(torch.mean(psnr(self(x0), x1, max_val)))


def evaluate_psnr(params: NSParams, field: VelocityField,
                  pairs: tuple[Tensor, Tensor], max_val: float = 1.0) -> float:
    """One-shot: build a session for ``params`` and score it on ``pairs``."""
    return Sampler(params, field).psnr(pairs, max_val)
