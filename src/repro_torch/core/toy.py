"""Analytic velocity fields for testing and paper-claim validation.

Port of ``repro.core.toy``. ``mixture_field`` is the exact marginal velocity
of a Gaussian-mixture data distribution under any Gaussian-path scheduler — a
closed-form 'pre-trained model' that validates BNS end to end (RK45 ground
truth, solver ordering, PSNR-vs-NFE) without training a network.
``linear_field`` has an exact ODE solution for hard numerical-correctness
tests. Everything is f32, on the state's device. ``mixture_field`` copies
nothing from the host when its time and its tensors lie there, as every
training and validation path on the card has them (a CUDA graph captures
those paths; ``benchmarks/psnr_vs_nfe.py::make_field`` builds it there).
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.parametrization import VelocityField
from repro_torch.core.schedulers import Scheduler

Tensor = torch.Tensor


def mixture_field(
    sched: Scheduler,
    means: Tensor,    # (K, d)
    stds: Tensor,     # (K,)  isotropic per-component std
    weights: Tensor,  # (K,)
) -> VelocityField:
    """Exact u_t(x) for q(x1) = sum_k w_k N(mu_k, s_k^2 I).

    x_t = alpha x1 + sigma eps  =>  u_t(x) = alpha' E[x1|x] + sigma' E[eps|x],
    with per-component Gaussian posteriors and softmax responsibilities.

    The per-component algebra cancels the 1/sigma singularity exactly:
      E[x1|x,k]  = mu_k + (alpha s_k^2 / v_k) (x - alpha mu_k)
      E[eps|x,k] = sigma (x - alpha mu_k) / v_k,     v_k = alpha^2 s_k^2 + sigma^2
    so the field is smooth on the closed interval [0, 1].
    """
    log_w = torch.log(weights / torch.sum(weights))

    def u(t, x: Tensor) -> Tensor:
        dev = x.device
        mu, sd, lw = means.to(dev), stds.to(dev), log_w.to(dev)
        t = torch.as_tensor(t, dtype=torch.float32, device=dev)
        a, s = sched.alpha(t), sched.sigma(t)
        da, ds = sched.dalpha(t), sched.dsigma(t)
        var_k = (a * sd) ** 2 + s**2                          # (K,)
        diff = x[..., None, :] - a * mu                       # (..., K, d)
        d = x.shape[-1]
        logp = lw - 0.5 * torch.sum(diff**2, -1) / var_k - 0.5 * d * torch.log(var_k)
        resp = torch.softmax(logp, dim=-1)                    # (..., K)
        gain = (a * sd**2) / var_k                            # (K,)
        x1_k = mu + gain[:, None] * diff                      # (..., K, d)
        eps_k = s * diff / var_k[:, None]                     # (..., K, d)
        u_k = da * x1_k + ds * eps_k
        return torch.sum(resp[..., None] * u_k, dim=-2)

    return VelocityField(fn=u, scheduler=sched)


def two_moons_means(k_per_moon: int = 8, radius: float = 1.0) -> Tensor:
    """Mixture centers tracing two interleaved half-circles (a 2D 'dataset')."""
    th = torch.linspace(0.0, math.pi, k_per_moon, dtype=torch.float32)
    m1 = torch.stack([radius * torch.cos(th), radius * torch.sin(th) - 0.3], -1)
    m2 = torch.stack([radius * torch.cos(th) + 1.0, -radius * torch.sin(th) + 0.3], -1)
    return torch.cat([m1, m2])


def linear_field(sched: Scheduler, rate: float = 1.5, drift: float = 0.7) -> VelocityField:
    """u_t(x) = -rate x + drift t : exact solution available (for exactness tests)."""

    def u(t, x: Tensor) -> Tensor:
        return -rate * x + drift * t

    return VelocityField(fn=u, scheduler=sched)


def linear_field_solution(x0: Tensor, t: float, rate: float = 1.5,
                          drift: float = 0.7) -> Tensor:
    """Closed-form solution of ``linear_field`` at time t from x(0)=x0:
    x(t) = x0 e^{-rt} + d [ t/r - (1 - e^{-rt})/r^2 ]."""
    e = torch.exp(torch.tensor(-rate * t, dtype=torch.float32, device=x0.device))
    return x0 * e + drift * (t / rate - (1.0 - e) / rate**2)
