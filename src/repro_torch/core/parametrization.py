"""Model-output parametrizations and their conversion to velocity fields.

Port of ``repro.core.parametrization``. Table 1 of the paper: the sampling
velocity is
    u_t(x) = beta_t * x + gamma_t * f_t(x)
with (beta, gamma) depending on whether f is a velocity, epsilon-prediction,
or x-prediction model.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core.schedulers import Scheduler

Tensor = torch.Tensor
# f(t, x) -> prediction; conditioning is closed over by the caller.
ModelFn = Callable[[Tensor, Tensor], Tensor]

VELOCITY = "velocity"
EPS_PRED = "eps"
X_PRED = "x"

PARAMETRIZATIONS = (VELOCITY, EPS_PRED, X_PRED)


def beta_gamma(sched: Scheduler, parametrization: str, t: Tensor):
    """Coefficients of Table 1 for ``u = beta x + gamma f``."""
    if parametrization == VELOCITY:
        return torch.zeros_like(t), torch.ones_like(t)
    a, s = sched.alpha(t), sched.sigma(t)
    da, ds = sched.dalpha(t), sched.dsigma(t)
    if parametrization == EPS_PRED:
        return da / a, (ds * a - s * da) / a
    if parametrization == X_PRED:
        return ds / s, (s * da - ds * a) / s
    raise ValueError(f"unknown parametrization {parametrization!r}")


@dataclasses.dataclass(frozen=True)
class VelocityField:
    """A sampling-ready velocity field u_t(x) built from a model f.

    ``fn(t, x)`` evaluates u; ``scheduler`` is the Gaussian-path scheduler the
    model was trained with (needed by ST transforms and dedicated solvers).
    """

    fn: ModelFn
    scheduler: Scheduler

    def __call__(self, t: Tensor, x: Tensor) -> Tensor:
        return self.fn(t, x)


def as_velocity_field(
    model: ModelFn, sched: Scheduler, parametrization: str = VELOCITY
) -> VelocityField:
    """Wrap an f-model (velocity / eps-pred / x-pred) into u_t(x) (Table 1)."""
    if parametrization == VELOCITY:
        return VelocityField(fn=model, scheduler=sched)

    def u(t: Tensor, x: Tensor) -> Tensor:
        t = sched.clip_t(t)
        beta, gamma = beta_gamma(sched, parametrization, t)
        return beta * x + gamma * model(t, x)

    return VelocityField(fn=u, scheduler=sched)


def eps_to_velocity(sched: Scheduler, t: Tensor, x: Tensor, eps: Tensor) -> Tensor:
    """u = beta x + gamma eps for an epsilon prediction at time ``t`` (Table 1)."""
    beta, gamma = beta_gamma(sched, EPS_PRED, t)
    return beta * x + gamma * eps


def x_to_velocity(sched: Scheduler, t: Tensor, x: Tensor, x1: Tensor) -> Tensor:
    """u = beta x + gamma x1 for an x (data) prediction at time ``t`` (Table 1)."""
    beta, gamma = beta_gamma(sched, X_PRED, t)
    return beta * x + gamma * x1
