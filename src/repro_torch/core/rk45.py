"""Adaptive Dormand-Prince RK45 (Shampine 1986) — the ground-truth sampler.

Port of ``repro.core.rk45``. The paper generates its BNS training and
validation pairs (x0, x(1)) with adaptive RK45 and reports PSNR against them.
Same tableau, the same error norm over the whole state (the root mean square
of (x5 - x4) / (atol + rtol max(|x|, |x5|)) over every element, so every batch
element shares one step size), the same accept test, step factor clip and
floor, seven field evaluations a step (FSAL is not reused, as in the
reference) and ``max_steps``. The reference's ``lax.while_loop`` is a Python
loop here: each step reads its error to the host once, to decide acceptance.
The step's time and size are carried in f32 on the host, as the reference
carries them in f32.

The reference jits the whole solve; the port's twin is one program of the
step body (``RK45Program``): the seven field evaluations, the 5th- and
4th-order combinations and the error norm, written into the program's own
buffers. On the card it is a CUDA graph, captured at a solve's first step
and replayed for every later step of every solve of the same field, shape
and tolerances that goes through the same ``RK45Program``
(``serving/programs.py::ProgramCache``); on the CPU, and under
``programs.disabled()``, the same code runs eagerly. Before each step the
host writes the stage times ``t + h C_i`` and ``h``, computed in f32 numpy,
into the program's time buffer with one copy, and the field takes 0-d views
of it as its ``t``: a field must do nothing on the host with ``t``. After
the step the host reads the error once and, on acceptance, copies x5 into
the program's state ``x``.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

Tensor = torch.Tensor
_F = np.float32

# Dormand-Prince Butcher tableau (DOPRI5), as the reference writes it: stage
# i (1..5) combines the earlier stages with row i - 1 of _A, whose first row is
# zeros, so each stage takes the row of the stage before it (stage 1
# evaluates at x itself). Kept as is: the port reproduces the reference's
# ground truth and its step counts (ROADMAP Queue C records it).
_C = [_F(c) for c in (0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0)]
_A = [
    [0, 0, 0, 0, 0, 0],
    [1 / 5, 0, 0, 0, 0, 0],
    [3 / 40, 9 / 40, 0, 0, 0, 0],
    [44 / 45, -56 / 15, 32 / 9, 0, 0, 0],
    [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729, 0, 0],
    [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656, 0],
]
_B5 = [35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0]
_B4 = [5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200, 187 / 2100, 1 / 40]


class RK45Result(NamedTuple):
    """``x1`` on x0's device; ``nfe``, ``accepted`` and ``rejected`` are
    Python ints (the reference returns int32 arrays)."""

    x1: Tensor
    nfe: int
    accepted: int
    rejected: int


class _Buffers(NamedTuple):
    times: Tensor   # (8,) f32: the 7 stage times, then h
    x: Tensor       # the accepted state
    x5: Tensor      # the step's 5th-order solution
    err: Tensor     # 0-d: the step's error norm


class RK45Program:
    """The step body of ``rk45_solve`` for one field ``u_fn`` on one device,
    as one program a (x shape, dtype, tolerances), through a
    ``ProgramCache`` (module docstring). Solves that pass the same
    ``RK45Program`` share its buffers and programs: the first step of the
    first solve of a shape captures, every later step replays. Drop it to
    free its graphs."""

    def __init__(self, u_fn: Callable[[Tensor, Tensor], Tensor], device):
        # function-level import: the serving package imports this module back
        from repro_torch.serving.programs import ProgramCache

        self.u_fn = u_fn
        self.programs = ProgramCache(device)
        self._buffers: dict[tuple, _Buffers] = {}

    def stats(self) -> dict:
        """Captured programs, replays and the summed capture ms."""
        return self.programs.stats()

    def step(self, times: np.ndarray, x0: Tensor, rtol: float, atol: float,
             first: bool) -> _Buffers:
        """One step from the program's state (``x0`` where ``first``) with the
        stage times and size ``times``; returns the buffers, x5 and err set."""
        key = (tuple(x0.shape), x0.dtype, rtol, atol)
        buf = self._buffers.get(key)
        if buf is None:
            dev = x0.device
            buf = self._buffers[key] = _Buffers(
                times=torch.zeros((8,), dtype=torch.float32, device=dev),
                x=torch.empty_like(x0), x5=torch.empty_like(x0),
                err=torch.zeros((), dtype=x0.dtype, device=dev))
        if first:
            buf.x.copy_(x0)
        buf.times.copy_(torch.from_numpy(times))

        def run():
            _rk_step(self.u_fn, buf, rtol, atol)

        self.programs(("rk45", rtol, atol), run, state=tuple(buf))
        return buf


def _rk_step(u_fn, buf: _Buffers, rtol: float, atol: float) -> None:
    """The step body: seven evaluations at the stage times ``buf.times[i]``
    (0-d views), x5 and x4, and the error norm, into ``buf.x5`` and
    ``buf.err``."""
    x, ht = buf.x, buf.times[7]
    ks = []
    for i in range(7):
        if i == 0:
            xi = x
        elif i < 6:
            acc = ks[0] * _A[i - 1][0]
            for j in range(1, i):
                acc = acc + ks[j] * _A[i - 1][j]
            xi = x + ht * acc
        if i < 6:
            ks.append(u_fn(buf.times[i], xi))
        else:
            # FSAL stage evaluated at t+h with the 5th-order solution.
            x5 = x + ht * sum(ks[j] * _B5[j] for j in range(6))
            ks.append(u_fn(buf.times[6], x5))
    x5 = x + ht * sum(ks[j] * _B5[j] for j in range(7))
    x4 = x + ht * sum(ks[j] * _B4[j] for j in range(7))
    scale = atol + rtol * torch.maximum(x.abs(), x5.abs())
    buf.err.copy_(torch.sqrt(torch.mean(((x5 - x4) / scale) ** 2)))
    buf.x5.copy_(x5)


def rk45_solve(
    u_fn: Callable[[Tensor, Tensor], Tensor],
    x0: Tensor,
    *,
    t0: float = 0.0,
    t1: float = 1.0,
    rtol: float = 1e-5,
    atol: float = 1e-5,
    h0: float = 0.01,
    max_steps: int = 10_000,
    program: Optional[RK45Program] = None,
) -> RK45Result:
    """Integrate dx/dt = u(t, x) from t0 to t1 adaptively.

    ``u_fn`` takes a 0-d f32 time tensor on x0's device and the full
    (batched) state. The solve runs under ``torch.no_grad()`` (the
    reference's while loop has no reverse-mode derivative either), through
    ``program`` (an ``RK45Program`` of ``u_fn``, shared by the caller's
    solves) or, where None, a program made for this solve.
    """
    if program is None:
        program = RK45Program(u_fn, x0.device)
    elif program.u_fn is not u_fn:
        raise ValueError("rk45_solve: the program was made for another field")
    t, h = _F(t0), _F(h0)
    limit = _F(t1 - 1e-12)
    acc = rej = steps = 0
    buf = None
    with torch.no_grad():
        while t < limit and steps < max_steps:
            h = min(h, _F(t1) - t)
            times = np.array([t + h * c for c in _C] + [h], dtype=np.float32)
            buf = program.step(times, x0, rtol, atol, first=buf is None)
            err = _F(buf.err.item())
            accept = bool(err <= 1.0)
            factor = _F(np.clip(_F(0.9) * (_F(1.0) / max(err, _F(1e-12))) ** _F(0.2),
                                _F(0.2), _F(5.0)))
            h_new = _F(h * factor)
            if accept:
                t = _F(t + h)
                buf.x.copy_(buf.x5)
            acc += accept
            rej += not accept
            h = max(h_new, _F(1e-8))
            steps += 1
        x1 = x0.clone() if buf is None else buf.x.clone()
    return RK45Result(x1=x1, nfe=7 * steps, accepted=acc, rejected=rej)
