"""Generic ODE solver programs (Sec. 3.3.1 / Appendix C).

Port of ``repro.core.solvers`` (numpy only, copied as is). Each solver is
written once as a *program* over the taxonomy backend
(`repro_torch.core.taxonomy`), so the same code runs numerically and converts to NS
parameters. Grids are Python/NumPy-level static sequences (standard for
diffusion samplers: the step schedule is fixed at trace time).

Naming: an "n-eval" solver makes exactly n model calls (n = NFE).
"""
from __future__ import annotations

import numpy as np


def uniform_grid(num_intervals: int, t0: float = 0.0, t1: float = 1.0) -> np.ndarray:
    return np.linspace(t0, t1, num_intervals + 1)


def power_grid(num_intervals: int, rho: float = 2.0) -> np.ndarray:
    """EDM-style warped grid (denser near data for rho>1), mapped to [0,1]."""
    s = np.linspace(0.0, 1.0, num_intervals + 1)
    return 1.0 - (1.0 - s) ** rho


# ---------------------------------------------------------------------------
# Runge-Kutta family
# ---------------------------------------------------------------------------


def euler_program(be, grid) -> None:
    """RK1. n evals for n intervals."""
    x = be.initial()
    for i in range(len(grid) - 1):
        h = grid[i + 1] - grid[i]
        u = be.eval_u(grid[i], x)
        x = be.combine([(1.0, x), (h, u)])
    be.finalize(x)


def midpoint_program(be, grid) -> None:
    """RK2 midpoint. 2 evals per interval."""
    x = be.initial()
    for i in range(len(grid) - 1):
        h = grid[i + 1] - grid[i]
        u1 = be.eval_u(grid[i], x)
        xm = be.combine([(1.0, x), (0.5 * h, u1)])
        u2 = be.eval_u(grid[i] + 0.5 * h, xm)
        x = be.combine([(1.0, x), (h, u2)])
    be.finalize(x)


def heun_program(be, grid) -> None:
    """RK2 trapezoidal (Heun; EDM's solver). 2 evals per interval."""
    x = be.initial()
    for i in range(len(grid) - 1):
        h = grid[i + 1] - grid[i]
        u1 = be.eval_u(grid[i], x)
        xe = be.combine([(1.0, x), (h, u1)])
        u2 = be.eval_u(grid[i + 1], xe)
        x = be.combine([(1.0, x), (0.5 * h, u1), (0.5 * h, u2)])
    be.finalize(x)


def rk4_program(be, grid) -> None:
    """Classic RK4. 4 evals per interval."""
    x = be.initial()
    for i in range(len(grid) - 1):
        t, h = grid[i], grid[i + 1] - grid[i]
        k1 = be.eval_u(t, x)
        x2 = be.combine([(1.0, x), (0.5 * h, k1)])
        k2 = be.eval_u(t + 0.5 * h, x2)
        x3 = be.combine([(1.0, x), (0.5 * h, k2)])
        k3 = be.eval_u(t + 0.5 * h, x3)
        x4 = be.combine([(1.0, x), (h, k3)])
        k4 = be.eval_u(t + h, x4)
        x = be.combine([
            (1.0, x),
            (h / 6.0, k1), (h / 3.0, k2), (h / 3.0, k3), (h / 6.0, k4),
        ])
    be.finalize(x)


# ---------------------------------------------------------------------------
# Multistep (Adams-Bashforth) family — nonuniform-grid coefficients
# ---------------------------------------------------------------------------


def _ab_weights(ts_hist: np.ndarray, t0: float, t1: float) -> np.ndarray:
    """Integrate the Lagrange interpolation of u over [t0, t1].

    ts_hist are the (distinct) past evaluation times; returns one weight per
    history point. Exact polynomial integration via the Vandermonde system.
    """
    m = len(ts_hist)
    # moments: integral of t^k over [t0, t1]
    ks = np.arange(m)
    moments = (t1 ** (ks + 1) - t0 ** (ks + 1)) / (ks + 1)
    V = np.vander(ts_hist, m, increasing=True).T  # V[k, j] = ts_hist[j]^k
    return np.linalg.solve(V, moments)


def adams_bashforth_program(be, grid, order: int = 2) -> None:
    """m-step AB on a (possibly nonuniform) grid. 1 eval per interval.

    Warms up with lower orders (AB1 = Euler on the first step, etc.).
    """
    x = be.initial()
    hist_t: list[float] = []
    hist_u: list = []
    for i in range(len(grid) - 1):
        u = be.eval_u(grid[i], x)
        hist_t.append(float(grid[i]))
        hist_u.append(u)
        m = min(order, len(hist_u))
        w = _ab_weights(np.asarray(hist_t[-m:]), float(grid[i]), float(grid[i + 1]))
        terms = [(1.0, x)] + [(float(w[j]), hist_u[-m + j]) for j in range(m)]
        x = be.combine(terms)
    be.finalize(x)


# ---------------------------------------------------------------------------
# Named registry (baselines for benchmarks / initializers for BNS)
# ---------------------------------------------------------------------------


def solver_program(name: str):
    progs = {
        "euler": euler_program,
        "midpoint": midpoint_program,
        "heun": heun_program,
        "rk4": rk4_program,
        "ab2": lambda be, grid: adams_bashforth_program(be, grid, order=2),
        "ab4": lambda be, grid: adams_bashforth_program(be, grid, order=4),
    }
    if name not in progs:
        raise KeyError(f"unknown solver {name!r}; have {sorted(progs)}")
    return progs[name]


def evals_per_interval(name: str) -> int:
    return {"euler": 1, "midpoint": 2, "heun": 2, "rk4": 4, "ab2": 1, "ab4": 1}[name]


def grid_for_nfe(name: str, nfe: int) -> np.ndarray:
    """Uniform grid such that the named solver makes exactly ``nfe`` evals."""
    per = evals_per_interval(name)
    if nfe % per:
        raise ValueError(f"{name} needs NFE divisible by {per}, got {nfe}")
    return uniform_grid(nfe // per)
