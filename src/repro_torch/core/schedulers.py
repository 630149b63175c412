"""Gaussian-path schedulers (alpha_t, sigma_t) and their calculus.

Port of ``repro.core.schedulers``. Conventions follow the paper (Shaul et al.,
ICML 2024): t=0 is source/noise, t=1 is data, ``alpha_0 = 0 = sigma_1``,
``alpha_1 = 1``, ``sigma_0 > 0`` (eq. 4), and ``snr(t) = alpha_t / sigma_t``
is strictly monotonically increasing.

Time derivatives are forward-mode AD (``torch.func.jvp``), the counterpart of
the reference's ``jax.jvp``, so no derivative is written by hand. ``jvp``
needs autograd's forward mode: call them outside ``torch.inference_mode``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

Tensor = torch.Tensor

# Clip away from the endpoints where snr is 0/inf.
_EPS = 1e-6


def _as_t(t) -> Tensor:
    return t if isinstance(t, Tensor) else torch.as_tensor(t, dtype=torch.float32)


def _d(fn: Callable[[Tensor], Tensor], t) -> Tensor:
    """Scalar-function time derivative via forward-mode AD."""
    t = _as_t(t)
    _, dot = torch.func.jvp(fn, (t,), (torch.ones_like(t),))
    return dot


@dataclasses.dataclass(frozen=True)
class Scheduler:
    """A Gaussian-path scheduler (alpha_t, sigma_t).

    ``snr_inverse`` maps an snr value back to t: t = snr^{-1}(v). It must be
    exact for the snr range the scheduler produces on (0, 1).
    """

    name: str
    alpha: Callable[[Tensor], Tensor]
    sigma: Callable[[Tensor], Tensor]
    snr_inverse: Callable[[Tensor], Tensor]

    def snr(self, t: Tensor) -> Tensor:
        return self.alpha(t) / self.sigma(t)

    def lam(self, t: Tensor) -> Tensor:
        """Half log-SNR's big brother: lambda_t = log snr(t) (paper's eq. 22)."""
        return torch.log(self.snr(t))

    def dalpha(self, t: Tensor) -> Tensor:
        return _d(self.alpha, t)

    def dsigma(self, t: Tensor) -> Tensor:
        return _d(self.sigma, t)

    def clip_t(self, t: Tensor) -> Tensor:
        return torch.clamp(_as_t(t), _EPS, 1.0 - _EPS)


# ---------------------------------------------------------------------------
# Concrete schedulers
# ---------------------------------------------------------------------------

def fm_ot() -> Scheduler:
    """Conditional-OT / rectified-flow scheduler: alpha=t, sigma=1-t (eq. 57)."""

    return Scheduler(
        name="fm_ot",
        alpha=lambda t: t,
        sigma=lambda t: 1.0 - t,
        # snr = t/(1-t)  =>  t = snr/(1+snr)
        snr_inverse=lambda v: v / (1.0 + v),
    )


def fm_cs() -> Scheduler:
    """Cosine scheduler (FM/v-CS): alpha=sin(pi t/2), sigma=cos(pi t/2) (eq. 58)."""

    half_pi = math.pi / 2.0
    return Scheduler(
        name="fm_cs",
        alpha=lambda t: torch.sin(half_pi * t),
        sigma=lambda t: torch.cos(half_pi * t),
        # snr = tan(pi t / 2)  =>  t = (2/pi) atan(snr)
        snr_inverse=lambda v: torch.atan(v) / half_pi,
    )


def vp(big_b: float = 20.0, small_b: float = 0.1) -> Scheduler:
    """Variance-Preserving scheduler (eq. 60).

    alpha_t = xi_{1-t}, sigma_t = sqrt(1 - xi_{1-t}^2),
    xi_s = exp(-s^2 (B - b)/4 - s b / 2), with B=20, b=0.1.
    """

    def xi(s: Tensor) -> Tensor:
        return torch.exp(-0.25 * s**2 * (big_b - small_b) - 0.5 * s * small_b)

    def alpha(t: Tensor) -> Tensor:
        return xi(1.0 - t)

    def sigma(t: Tensor) -> Tensor:
        return torch.sqrt(torch.clamp(1.0 - xi(1.0 - t) ** 2, min=1e-20))

    def snr_inverse(v: Tensor) -> Tensor:
        # snr = xi / sqrt(1 - xi^2)  =>  xi = v / sqrt(1 + v^2)
        # log xi = -(B-b)/4 s^2 - b/2 s  => quadratic in s = 1 - t.
        log_xi = torch.log(v) - 0.5 * torch.log1p(v**2)
        a_q = 0.25 * (big_b - small_b)
        b_q = 0.5 * small_b
        # a_q s^2 + b_q s + log_xi = 0, take the positive root.
        disc = torch.sqrt(torch.clamp(b_q**2 - 4.0 * a_q * log_xi, min=0.0))
        s = (-b_q + disc) / (2.0 * a_q)
        return 1.0 - s

    return Scheduler(name="vp", alpha=alpha, sigma=sigma, snr_inverse=snr_inverse)


def ve(sigma_max: float = 80.0) -> Scheduler:
    """Variance-Exploding / EDM target scheduler (eq. 16).

    alpha_r = 1, sigma_r = sigma_max (1 - r). Note alpha_0 != 0; this is the
    *target* of EDM's scheduler change, valid as such (the paper, sec 3.3.2).
    """

    return Scheduler(
        name="ve",
        alpha=lambda t: torch.ones_like(t),
        sigma=lambda t: sigma_max * (1.0 - t),
        # snr = 1 / (sigma_max (1 - r))  =>  r = 1 - 1/(sigma_max v)
        snr_inverse=lambda v: 1.0 - 1.0 / (sigma_max * v),
    )


def scaled_sigma(base: Scheduler, sigma0: float) -> Scheduler:
    """Preconditioning scheduler change of eq. 14: sigma->sigma0*sigma, alpha kept.

    Corresponds to a source distribution with std sigma0.
    """

    return Scheduler(
        name=f"{base.name}_s{sigma0:g}",
        alpha=base.alpha,
        sigma=lambda t: sigma0 * base.sigma(t),
        # snr_new(t) = snr_base(t)/sigma0  =>  inverse(v) = base_inverse(v*sigma0)
        snr_inverse=lambda v: base.snr_inverse(v * sigma0),
    )


_REGISTRY: dict[str, Callable[[], Scheduler]] = {
    "fm_ot": fm_ot,
    "fm_cs": fm_cs,
    "vp": vp,
    "ve": ve,
}


def get_scheduler(name: str) -> Scheduler:
    if name not in _REGISTRY:
        raise KeyError(f"unknown scheduler {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]()
