"""Exponential-integrator solvers: DDIM and DPM-Solver++ (Sec. 3.3.2).

Port of ``repro.core.exponential``. Written as taxonomy programs, so each
converts to NS parameters exactly.

The model's x-prediction is recovered from the velocity field through the
Table-1 relation ``u = beta x + gamma x_hat`` (exact for Gaussian paths), so
these solvers work with *any* parametrization once wrapped as a velocity
field. Coefficients are computed in the algebraically-stable form
``sigma_{i+1} e^{lambda} -> alpha`` so nothing overflows near t = 1. Every
coefficient is an f32 scalar tensor on the CPU, and grid times are rounded
to f32 before use, as the reference's ``jnp.asarray`` rounds them.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.parametrization import X_PRED, beta_gamma
from repro_torch.core.schedulers import Scheduler, _as_t


def exp_grid(
    sched: Scheduler, nfe: int, t_min: float = 1e-3, t_max: float = 1.0 - 1e-3
) -> np.ndarray:
    """Uniform-in-lambda (log-SNR) time grid — the standard grid for
    exponential integrators (Lu et al. 2022). Ends at t_max < 1 (sigma_min>0),
    matching practice; step sizes h_i are then equal and bounded. lambda and
    the times are f32, returned as float64 with the endpoints pinned."""
    lam = _linspace(sched.lam(_as_t(t_min)), sched.lam(_as_t(t_max)), nfe + 1)
    ts = sched.snr_inverse(torch.exp(lam))
    grid = ts.numpy().astype(np.float64)
    grid[0], grid[-1] = t_min, t_max
    return grid


def _linspace(start: torch.Tensor, stop: torch.Tensor, num: int) -> torch.Tensor:
    """The reference's f32 ``jnp.linspace``: ``start (1 - s) + stop s`` at
    s = i / (num - 1), the last term fused as XLA's CPU backend fuses it (one
    rounding, emulated in f64), then ``stop``. Within 1 f32 ulp of it on
    every grid the tests take; ``torch.linspace`` is up to 6 ulps off."""
    div = num - 1
    step = torch.arange(div, dtype=torch.float32) / torch.tensor(float(div))
    head = (start * (1 - step)).double() + stop.double() * step.double()
    return torch.cat([head.float(), stop.reshape(1)])


def _xhat(be, sched: Scheduler, t, x, u):
    """Invert Table 1: x_hat = (u - beta x) / gamma at (clipped) time t."""
    tc = sched.clip_t(_as_t(t))
    beta, gamma = beta_gamma(sched, X_PRED, tc)
    return be.combine([(1.0 / gamma, u), (-beta / gamma, x)])


def ddim_program(be, grid, sched: Scheduler) -> None:
    """DDIM (Song et al. 2022) == first-order exponential integrator.

    x_{i+1} = (sigma_{i+1}/sigma_i) x_i + (alpha_{i+1} - sigma_{i+1} snr_i) x_hat_i
    """
    x = be.initial()
    for i in range(len(grid) - 1):
        t, tn = _as_t(grid[i]), _as_t(grid[i + 1])
        a_i, s_i = sched.alpha(sched.clip_t(t)), sched.sigma(sched.clip_t(t))
        a_n, s_n = sched.alpha(tn), sched.sigma(tn)
        u = be.eval_u(t, x)
        xh = _xhat(be, sched, t, x, u)
        x = be.combine([(s_n / s_i, x), (a_n - s_n * a_i / s_i, xh)])
    be.finalize(x)


def dpm2m_program(be, grid, sched: Scheduler, exact: bool = False) -> None:
    """DPM-Solver++(2M) (Lu et al. 2022b): 2nd-order multistep in lambda-space.

      x_{i+1} = (sig_{i+1}/sig_i) x_i + sig_{i+1} I0 * D_i
      D_i = x_hat_i + (h_i / (2 h_{i-1})) (x_hat_i - x_hat_{i-1})      (Lu et al.)
      sig_{i+1} I0 = alpha_{i+1} (1 - e^{-h_i})   [stable form]

    ``exact=True`` instead integrates the linear extrapolation exactly:
      I1 = e^{lam_{i+1}} (h - 1) + e^{lam_i} replaces the midpoint rule.
    First step falls back to DDIM (no history). Use with ``exp_grid``.
    """
    x = be.initial()
    prev = None  # (lam_prev, xhat_prev)
    for i in range(len(grid) - 1):
        t, tn = _as_t(grid[i]), _as_t(grid[i + 1])
        tc, tnc = sched.clip_t(t), sched.clip_t(tn)
        s_i = sched.sigma(tc)
        a_n, s_n = sched.alpha(tnc), sched.sigma(tnc)
        lam_i, lam_n = sched.lam(tc), sched.lam(tnc)
        snr_i = sched.snr(tc)
        h = lam_n - lam_i

        u = be.eval_u(t, x)
        xh = _xhat(be, sched, t, x, u)

        # sigma_{i+1} I0 = alpha_{i+1} - sigma_{i+1} snr_i = alpha_{i+1}(1 - e^{-h})
        sI0 = a_n - s_n * snr_i
        terms = [(s_n / s_i, x)]
        if prev is None:
            terms.append((sI0, xh))
        else:
            lam_p, xh_p = prev
            r = lam_i - lam_p
            if exact:
                # sigma_{i+1} I1 = alpha_{i+1} (h - 1) + sigma_{i+1} snr_i
                c = (a_n * (h - 1.0) + s_n * snr_i) / r
            else:
                c = sI0 * h / (2.0 * r)
            terms += [(sI0 + c, xh), (-c, xh_p)]
        x = be.combine(terms)
        prev = (lam_i, xh)
    be.finalize(x)


def exponential_program(name: str):
    progs = {"ddim": ddim_program, "dpm2m": dpm2m_program}
    if name not in progs:
        raise KeyError(f"unknown exponential solver {name!r}; have {sorted(progs)}")
    return progs[name]
