"""Bespoke Scale-Time (BST) solvers (Shaul et al. 2023) — the prior
solver-distillation baseline the paper compares against (Figs. 4, 11).

Port of ``repro.core.bst_solver``. A BST solver is a generic base solver
(here: Euler or Midpoint) applied to an ST-transformed field whose (t_r, s_r)
— and their derivatives — are free per-knot parameters. Written as a
taxonomy program, so (a) it trains with the same Algorithm-2 harness as BNS
and (b) it converts exactly to NS parameters, demonstrating the ST ⊂ NS
inclusion of Theorem 3.2 on the *trained* solver.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.schedulers import _as_t
from repro_torch.core.st_transform import STTransform

Tensor = torch.Tensor


class BSTParams(NamedTuple):
    """Unconstrained BST parameters at k knots (k = #evals + 1).

    time_logits: (k-1,) -> positive increments, cumsum -> t grid with t_0=0, t_{k-1}=1.
    log_s:       (k,)   -> s = exp(log_s) > 0 at each knot.
    log_dt:      (k,)   -> t' = exp(log_dt) > 0 (monotone time reparam).
    ds:          (k,)   -> s' unconstrained.
    """

    time_logits: Tensor
    log_s: Tensor
    log_dt: Tensor
    ds: Tensor


class BSTKnots(NamedTuple):
    t: Tensor   # (k,)
    s: Tensor   # (k,)
    dt: Tensor  # (k,)
    ds: Tensor  # (k,)


def bst_params_from_numpy(time_logits, log_s, log_dt, ds, device="cpu") -> BSTParams:
    """``BSTParams`` from the reference's arrays as numpy, f32 on ``device``."""
    return BSTParams(*(torch.tensor(np.asarray(x, np.float32), device=device)
                       for x in (time_logits, log_s, log_dt, ds)))


def materialize_bst(p: BSTParams) -> BSTKnots:
    d = torch.softmax(p.time_logits, dim=0)
    t = torch.cat([torch.zeros((1,), dtype=d.dtype, device=d.device), torch.cumsum(d, 0)])
    return BSTKnots(t=t, s=torch.exp(p.log_s), dt=torch.exp(p.log_dt), ds=p.ds)


def knot_positions(num_evals: int, base: str = "euler") -> Tensor:
    """r-positions of the knots for a given base solver."""
    if base == "euler":
        return torch.linspace(0.0, 1.0, num_evals + 1)
    if base == "midpoint":
        assert num_evals % 2 == 0, "midpoint BST needs an even NFE"
        return torch.linspace(0.0, 1.0, num_evals + 1)  # 2m+1 knots incl. midpoints
    raise KeyError(base)


def identity_bst(num_evals: int, base: str = "euler") -> BSTParams:
    """BST initialized at the identity ST transform (== plain base solver)."""
    k = knot_positions(num_evals, base).shape[0]
    return BSTParams(
        time_logits=torch.zeros((k - 1,)),
        log_s=torch.zeros((k,)),
        log_dt=torch.zeros((k,)),
        ds=torch.zeros((k,)),
    )


def from_st_transform(st: STTransform, num_evals: int, base: str = "euler") -> BSTParams:
    """Initialize BST knots from a continuous ST transform (e.g. sigma0 precond).

    Each knot is evaluated alone (the reference's ``jax.vmap`` over r)."""
    r = knot_positions(num_evals, base)

    def each(fn) -> Tensor:
        return torch.stack([fn(_as_t(ri)) for ri in r])

    t = each(st.t)
    gaps = torch.clamp(torch.diff(t), min=1e-6)
    return BSTParams(
        time_logits=torch.log(gaps),
        log_s=torch.log(torch.clamp(each(st.s), min=1e-8)),
        log_dt=torch.log(torch.clamp(each(st.dt), min=1e-6)),
        ds=each(st.ds),
    )


def bst_euler_program(be, knots: BSTKnots) -> None:
    """ST-Euler with per-knot parameters; r-grid uniform on [0,1].

    x_bar_{i+1} = x_bar_i + h [ (s'_i/s_i) x_bar_i + t'_i s_i u_{t_i}(x_bar_i/s_i) ]
    with x_bar maintained implicitly: trajectory points are x_i = x_bar_i/s_i.
    """
    k = knots.t.shape[0]
    n = k - 1
    h = 1.0 / n
    xbar = be.combine([(knots.s[0], be.initial())])
    for i in range(n):
        x = be.combine([(1.0 / knots.s[i], xbar)])
        u = be.eval_u(knots.t[i], x)
        xbar = be.combine([
            (1.0 + h * knots.ds[i] / knots.s[i], xbar),
            (h * knots.dt[i] * knots.s[i], u),
        ])
    be.finalize(be.combine([(1.0 / knots.s[n], xbar)]))


def bst_midpoint_program(be, knots: BSTKnots) -> None:
    """ST-Midpoint: knots at every eval point (2 per interval + endpoint).

    knots arrays have length 2m+1 for m intervals; evals at knots 0,1,3,5,...
    """
    k = knots.t.shape[0]
    assert k % 2 == 1, "midpoint BST needs an odd number of knots (2m+1)"
    m = (k - 1) // 2
    h = 1.0 / m
    xbar = be.combine([(knots.s[0], be.initial())])
    for i in range(m):
        lo, mid, hi = 2 * i, 2 * i + 1, 2 * i + 2
        x = be.combine([(1.0 / knots.s[lo], xbar)])
        u1 = be.eval_u(knots.t[lo], x)
        xbar_mid = be.combine([
            (1.0 + 0.5 * h * knots.ds[lo] / knots.s[lo], xbar),
            (0.5 * h * knots.dt[lo] * knots.s[lo], u1),
        ])
        xm = be.combine([(1.0 / knots.s[mid], xbar_mid)])
        u2 = be.eval_u(knots.t[mid], xm)
        xbar = be.combine([
            (1.0 + h * knots.ds[mid] / knots.s[mid], xbar),
            (h * knots.dt[mid] * knots.s[mid], u2),
        ])
    be.finalize(be.combine([(1.0 / knots.s[k - 1], xbar)]))
