"""Scale-Time (ST) transformations and post-training scheduler changes.

Port of ``repro.core.st_transform``. Implements eqs. 6-8 and the
preconditioning of eq. 14 of the paper:

    x_bar(r) = s_r x(t_r)                                   (eq. 6)
    u_bar_r(x) = (s'_r / s_r) x + t'_r s_r u_{t_r}(x / s_r)  (eq. 7)

For strictly-monotone SnR, ST transforms are 1-1 with scheduler changes
(alpha, sigma) -> (alpha_bar, sigma_bar) via

    t_r = snr^{-1}(snr_bar(r)),   s_r = sigma_bar_r / sigma_{t_r}   (eq. 8)

The time/scale functions are closures over the schedulers, and the
derivatives in eq. 7 come from forward-mode AD (``torch.func.jvp``, the
reference's ``jax.jvp``): no hand-derived formulas.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core.parametrization import VelocityField
from repro_torch.core.schedulers import Scheduler, _as_t, _d, scaled_sigma

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class STTransform:
    """A Scale-Time transformation (s_r, t_r), r in [0, 1].

    ``t(0)=0, t(1)=1, s_0, s_1 > 0``. ``s1`` is exposed so callers can recover
    original samples: x(1) = x_bar(1) / s_1.
    """

    t: Callable[[Tensor], Tensor]
    s: Callable[[Tensor], Tensor]

    def dt(self, r: Tensor) -> Tensor:
        return _d(self.t, r)

    def ds(self, r: Tensor) -> Tensor:
        return _d(self.s, r)

    @property
    def s1(self) -> Tensor:
        return self.s(_as_t(1.0))

    @property
    def s0(self) -> Tensor:
        return self.s(_as_t(0.0))


def identity_st() -> STTransform:
    return STTransform(t=lambda r: r, s=lambda r: torch.ones_like(r))


def scheduler_change_st(source: Scheduler, target: Scheduler) -> STTransform:
    """ST transform realizing a scheduler change source -> target (eq. 8)."""

    def t_of_r(r: Tensor) -> Tensor:
        r = source.clip_t(r)
        return source.snr_inverse(target.snr(r))

    def s_of_r(r: Tensor) -> Tensor:
        r = source.clip_t(r)
        return target.sigma(r) / source.sigma(t_of_r(r))

    return STTransform(t=t_of_r, s=s_of_r)


def transformed_field(u: VelocityField, st: STTransform) -> VelocityField:
    """The transformed velocity u_bar generating the ST-transformed paths (eq. 7)."""

    def u_bar(r: Tensor, x: Tensor) -> Tensor:
        r = _as_t(r)
        s, ds, t, dt = st.s(r), st.ds(r), st.t(r), st.dt(r)
        return (ds / s) * x + dt * s * u.fn(t, x / s)

    # The transformed path's scheduler is (s_r alpha_{t_r}, s_r sigma_{t_r}).
    bar_sched = Scheduler(
        name=f"{u.scheduler.name}_st",
        alpha=lambda r: st.s(r) * u.scheduler.alpha(st.t(r)),
        sigma=lambda r: st.s(r) * u.scheduler.sigma(st.t(r)),
        # snr_bar(r) = snr(t_r); inverse(v) = r with t_r = snr^{-1}(v).
        snr_inverse=lambda v: _invert_monotone(
            lambda r: st.s(r) * u.scheduler.alpha(st.t(r))
            / (st.s(r) * u.scheduler.sigma(st.t(r))),
            v,
        ),
    )
    return VelocityField(fn=u_bar, scheduler=bar_sched)


def precondition(u: VelocityField, sigma0: float) -> tuple[VelocityField, STTransform]:
    """Paper eq. 14 preconditioning: move to sigma_bar = sigma0 * sigma.

    Returns the preconditioned field u_bar and the ST transform used, so the
    sampler can (a) draw x_bar(0) ~ N(0, sigma0^2 sigma_0^2) = s_0-scaled
    source, and (b) unscale final samples by 1/s_1.
    """
    target = scaled_sigma(u.scheduler, sigma0)
    st = scheduler_change_st(u.scheduler, target)
    return transformed_field(u, st), st


def _invert_monotone(fn: Callable[[Tensor], Tensor], v: Tensor, iters: int = 63) -> Tensor:
    """Bisection inverse of a strictly increasing fn on [0, 1]: ``iters``
    halvings in a Python loop (the reference's ``fori_loop``)."""
    v = _as_t(v)
    lo = torch.zeros_like(v)
    hi = torch.ones_like(v)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        below = fn(mid) < v
        lo, hi = torch.where(below, mid, lo), torch.where(below, hi, mid)
    return 0.5 * (lo + hi)
