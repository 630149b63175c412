"""Anytime-BNS: ONE solver that serves multiple NFE budgets (beyond-paper).

Port of ``repro.core.anytime``. The paper's stated limitation (Sec. 6): BNS
needs a different solver for each NFE. The construction here: a single NS
solver with n = max(budgets) velocity evaluations plus one extra OUTPUT rule
(early exit) per smaller budget m,

    x_out^m = x0 * a_m + sum_{j<m} b_mj u_j ,

so every truncation is a bona-fide m-step solver, trained jointly on the
per-budget PSNR losses. The eval times follow a NON-MONOTONE NESTED grid
(each budget's prefix spreads over [0, 1) like a dedicated grid); the
monotone "prefix" init is kept for the ablation.

The update hook keeps the port's contract (``ns_solver.ns_sample``): a rule
after k evaluations is handed only ``U[:k]`` and its k live weights (the
reference passes the whole buffer with the later weights masked to zero,
which adds nothing). Intermediate rule i gets ``U[:i+1]``, ``a[i]`` and
``b[i, :i+1]``; the exit of budget m gets ``U[:m]``, ``exit_a[bi]`` and
``exit_b[bi, :m]``. Every exit therefore performs the same launches on the
same inputs as the extracted m-step solver (``extract_ns``) through
``ns_sample``, and equals it to the bit, on the CPU and through the kernel.
How ``U[:k]`` is made depends on autograd, as in ``ns_sample``: under
``torch.no_grad()`` a leg writes each velocity into its own copy of the
carry's buffer; under grad nothing is written in place and the velocities
so far are stacked for each rule (``train_anytime`` differentiates through
them, on the card through the ``ns_update`` backward kernel).

Parameters: n(n+5)/2 + 1 + sum_{m<n}(m+1) as the paper counts them.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core.bns import BNSTrainConfig, TrainResult, fit, psnr
from repro_torch.core.ns_solver import NSParams
from repro_torch.core.parametrization import VelocityField
from repro_torch.kernels.ns_update.ops import fused_ns_update

Tensor = torch.Tensor


class AnytimeParams(NamedTuple):
    time_raw: Tensor  # (n,) eval times = sigmoid(time_raw) — NOT constrained
    #                   to be monotone (the nested grid is deliberately not)
    a: Tensor         # (n,) x0 coefficients of the intermediate update rules
    b: Tensor         # (n, n) velocity coefficients (row i uses j <= i)
    exit_a: Tensor    # (num_small,) x0 coefficient per early exit
    exit_b: Tensor    # (num_small, n) velocity coeffs (entries >= m unused)


def anytime_params_from_numpy(time_raw, a, b, exit_a, exit_b, device="cpu") -> AnytimeParams:
    """``AnytimeParams`` from the reference's arrays as numpy (``np.asarray``
    of each field), f32 on ``device``."""
    return AnytimeParams(*(torch.tensor(np.asarray(x, np.float32), device=device)
                           for x in (time_raw, a, b, exit_a, exit_b)))


def _logit(t: Tensor) -> Tensor:
    t = torch.clamp(t, 0.02, 0.98)
    return torch.log(t / (1.0 - t))


def nested_grid(budgets: Sequence[int]) -> np.ndarray:
    """Non-monotone nested eval times: each budget's prefix spreads [0, 1)."""
    budgets = sorted(budgets)
    times: list[float] = []
    seen: set[float] = set()
    for m in budgets:
        for t in [i / m for i in range(m)]:
            if t not in seen:
                seen.add(t)
                times.append(t)
    n = budgets[-1]
    assert len(times) == n, (times, budgets)
    return np.asarray(times)


def _f32(x) -> Tensor:
    return torch.tensor(np.asarray(x), dtype=torch.float32)


def init_anytime(field: VelocityField | None, budgets: Sequence[int],
                 mode: str = "nested", init_solver: str = "midpoint",
                 sigma0: float = 1.0) -> AnytimeParams:
    """The initial solver, f32 on the CPU: the nested grid with crude
    Euler-from-x0 rules (``mode="nested"``), or the monotone ``init_solver``
    at n with its m-step solvers' last rules as exits (``"prefix"``)."""
    # function-level import: solvers.spec imports this module back
    from repro_torch.solvers.registry import build_ns

    budgets = sorted(budgets)
    n = budgets[-1]
    if mode == "prefix":
        ns0 = build_ns(init_solver, n, field, sigma0=sigma0)
        exits_a, exits_b = [], []
        for m in budgets[:-1]:
            ns_m = build_ns(init_solver, m, field, sigma0=sigma0)
            exits_a.append(ns_m.a[-1])
            exits_b.append(torch.nn.functional.pad(ns_m.b[-1], (0, n - m)))
        return AnytimeParams(time_raw=_logit(ns0.times), a=ns0.a, b=ns0.b,
                             exit_a=torch.stack(exits_a), exit_b=torch.stack(exits_b))
    assert mode == "nested", mode
    times0 = nested_grid(budgets)
    # crude Euler-from-x0 rules (x_{i+1} = x0 + t_next u_i); training refines
    b = np.zeros((n, n))
    nxt = np.concatenate([times0[1:], [1.0]])
    for i in range(n):
        b[i, i] = nxt[i]
    exit_b = np.zeros((len(budgets) - 1, n))
    for bi, m in enumerate(budgets[:-1]):
        exit_b[bi, :m] = 1.0 / m   # Euler composition over that prefix
    return AnytimeParams(time_raw=_logit(_f32(times0)), a=_f32(np.ones(n)), b=_f32(b),
                         exit_a=_f32(np.ones(len(budgets) - 1)), exit_b=_f32(exit_b))


class AnytimeCarry(NamedTuple):
    """Resumable state of the shared trajectory after ``step`` evaluations.

    The state after k evals is a pure function of ``x0`` and ``U[:k]``
    (Prop. 3.1), so this tuple is everything a later leg needs.

    x0:   the noise each row integrates from (batched leading dims).
    U:    (n, *x0.shape) recorded velocities; rows >= ``step`` are zeros.
    x:    trajectory state after ``step`` update rules.
    step: number of velocity evaluations done so far (a Python int).
    """

    x0: Tensor
    U: Tensor
    x: Tensor
    step: int


def anytime_carry(params: AnytimeParams, budgets: Sequence[int],
                  x0: Tensor) -> AnytimeCarry:
    """A fresh carry at step 0 (no backbone forwards spent)."""
    n = sorted(budgets)[-1]
    # x0's own factory: a DTensor (the mesh path's) gets a DTensor buffer
    return AnytimeCarry(x0=x0, U=x0.new_zeros((n,) + tuple(x0.shape)), x=x0, step=0)


def anytime_extend(params: AnytimeParams, budgets: Sequence[int],
                   u_fn: Callable, carry: AnytimeCarry, stop: int, *,
                   update_fn: Callable | None = None
                   ) -> tuple[AnytimeCarry, dict[int, Tensor]]:
    """Advance the shared trajectory from ``carry.step`` to ``stop`` evals,
    emitting the early-exit output of every budget crossed on the way.

    Exit-boundary join invariant (continuous batching rests on it): for any
    boundary k and served budget m > k, a request's prefix leg to k from its
    own noise, then the leg k -> m, gives the budget-m exit that the
    extracted m-step solver (``extract_ns(m)`` through ``ns_sample``) gives
    in one go, to the bit: rows 0..m-2 of the extracted solver are the shared
    rules, and every rule here is handed the same ``U[:k]`` and live weights
    that ``ns_sample`` hands it (module docstring).

    Costs exactly ``stop - carry.step`` velocity evaluations. ``a``, ``b``
    and the exits are made f32 once a call, on x0's device; the input carry
    is left as it was. ``update_fn(x0, U, a_i, w_i)`` defaults to
    ``fused_ns_update`` (the kernel on the card), as in ``ns_sample``.
    """
    budgets = sorted(budgets)
    n = budgets[-1]
    if not 0 <= carry.step < stop <= n:
        raise ValueError(f"cannot extend from step {carry.step} to {stop} "
                         f"(top budget {n})")
    if update_fn is None:
        update_fn = fused_ns_update
    dev = carry.x0.device
    time_raw, a, b, exit_a, exit_b = (p.to(dev) for p in params)
    times = torch.sigmoid(time_raw)
    a, b, exit_a, exit_b = (p.to(torch.float32).contiguous() for p in (a, b, exit_a, exit_b))
    exit_of = {m: bi for bi, m in enumerate(budgets[:-1])}
    x0, x = carry.x0, carry.x
    grad = torch.is_grad_enabled()
    if grad:
        us = list(carry.U[:carry.step])
    else:
        U = carry.U.clone()
    outs: dict[int, Tensor] = {}
    for i in range(carry.step, stop):
        u = u_fn(times[i], x)
        if grad:
            us.append(u)
            live = torch.stack(us)
        else:
            U[i] = u
            live = U[: i + 1]
        x = update_fn(x0, live, a[i], b[i, : i + 1])
        if i + 1 in exit_of:
            bi = exit_of[i + 1]
            outs[i + 1] = update_fn(x0, live, exit_a[bi], exit_b[bi, : i + 1])
    if stop == n:
        outs[n] = x
    if grad:
        U = torch.cat([torch.stack(us), carry.U[stop:]])
    return AnytimeCarry(x0=x0, U=U, x=x, step=stop), outs


def anytime_sample(params: AnytimeParams, budgets: Sequence[int],
                   u_fn: Callable, x0: Tensor, *,
                   update_fn: Callable | None = None) -> dict[int, Tensor]:
    """Run the shared trajectory once; emit one sample per budget (stopping
    after m evaluations costs exactly m NFE). One full-length
    ``anytime_extend`` leg."""
    budgets = sorted(budgets)
    _, outs = anytime_extend(params, budgets, u_fn, anytime_carry(params, budgets, x0),
                             budgets[-1], update_fn=update_fn)
    return outs


def extract_ns(params: AnytimeParams, budgets: Sequence[int], m: int) -> NSParams:
    """The bona-fide m-step NS solver embedded in an anytime solver.

    Rows 0..m-2 are the shared intermediate update rules; row m-1 is budget
    m's OUTPUT rule (the early exit for a small budget, the final shared rule
    for the top one). The times are ``anytime_extend``'s, the sigmoid of the
    whole ``time_raw`` cut to m."""
    budgets = sorted(budgets)
    n = budgets[-1]
    if m not in budgets:
        raise ValueError(f"budget {m} not served; have {tuple(budgets)}")
    times = torch.sigmoid(params.time_raw)[:m]
    if m == n:
        return NSParams(times=times, a=params.a, b=params.b)
    bi = budgets.index(m)
    a = torch.cat([params.a[:m - 1], params.exit_a[bi][None]])
    b = torch.cat([params.b[:m - 1, :m], params.exit_b[bi, :m][None]], dim=0)
    return NSParams(times=times, a=a, b=b)


def anytime_loss(theta: AnytimeParams, budgets: Sequence[int], u_fn: Callable,
                 x0: Tensor, x1: Tensor, weights: dict | None = None) -> Tensor:
    """``train_anytime``'s loss: the weighted mean over budgets of the PSNR
    loss E log ||x_m - x(1)||^2 of each exit (by default the top budget,
    which owns the most parameters, weighs 2, the others 1)."""
    budgets = sorted(budgets)
    if weights is None:
        weights = {m: (2.0 if m == budgets[-1] else 1.0) for m in budgets}
    outs = anytime_sample(theta, budgets, u_fn, x0)
    total = 0.0
    for m in budgets:
        mse = torch.mean((outs[m] - x1) ** 2, dim=tuple(range(1, x0.dim())))
        total = total + weights[m] * torch.mean(torch.log(torch.clamp(mse, min=1e-20)))
    return total / sum(weights.values())


def train_anytime(field: VelocityField, budgets: Sequence[int], train_pairs,
                  val_pairs, cfg: BNSTrainConfig, *, mode: str = "nested",
                  weights: dict | None = None, log=None) -> TrainResult:
    """Joint Algorithm-2 optimization of the shared solver and its early
    exits (``bns.fit``: the reference's mini-batches; on the card one
    captured step and one captured validation); the validation score is
    the mean over budgets of each exit's val PSNR."""
    budgets = sorted(budgets)
    theta0 = init_anytime(field, budgets, mode, cfg.init_solver, cfg.sigma0)
    res = fit(*anytime_objective(field, budgets, val_pairs, cfg, weights), theta0,
              train_pairs, cfg, log=log,
              line=lambda it, loss, vp: f"anytime iter {it}: loss={loss:.3f} "
                                        f"mean_psnr={vp:.2f}dB")
    res.nfe = budgets[-1]
    return res


def anytime_objective(field: VelocityField, budgets: Sequence[int], val_pairs,
                      cfg: BNSTrainConfig, weights: dict | None = None):
    """``train_anytime``'s ``loss_fn(theta, x0b, x1b)`` (``anytime_loss``)
    and ``val_psnr_fn(theta)``, the mean over budgets of each exit's val
    PSNR (0-d)."""
    budgets = sorted(budgets)

    def val_psnr(theta) -> Tensor:
        outs = anytime_sample(theta, budgets, field.fn, val_pairs[0])
        return torch.mean(torch.stack(
            [torch.mean(psnr(outs[m], val_pairs[1], cfg.max_val)) for m in budgets]))

    return (lambda th, x0, x1: anytime_loss(th, budgets, field.fn, x0, x1, weights)), val_psnr


def evaluate_anytime(params: AnytimeParams, budgets: Sequence[int],
                     field: VelocityField, pairs, max_val: float = 1.0
                     ) -> dict[int, float]:
    x0, x1 = pairs
    with torch.no_grad():
        outs = anytime_sample(params, sorted(budgets), field.fn, x0)
    return {m: float(torch.mean(psnr(outs[m], x1, max_val))) for m in outs}
