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
"""
from __future__ import annotations

from typing import Callable, NamedTuple

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
) -> RK45Result:
    """Integrate dx/dt = u(t, x) from t0 to t1 adaptively.

    ``u_fn`` takes a 0-d f32 time tensor on x0's device and the full
    (batched) state. Call it under ``torch.no_grad()`` unless the solve is
    to be differentiated.
    """
    dev = x0.device

    def tt(v) -> Tensor:
        return torch.tensor(float(v), dtype=torch.float32, device=dev)

    def rk_step(t, x, h):
        ht = tt(h)
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
                ks.append(u_fn(tt(t + h * _C[i]), xi))
            else:
                # FSAL stage evaluated at t+h with the 5th-order solution.
                x5 = x + ht * sum(ks[j] * _B5[j] for j in range(6))
                ks.append(u_fn(tt(t + h), x5))
        x5 = x + ht * sum(ks[j] * _B5[j] for j in range(7))
        x4 = x + ht * sum(ks[j] * _B4[j] for j in range(7))
        return x5, x4

    t, h, x = _F(t0), _F(h0), x0
    limit = _F(t1 - 1e-12)
    acc = rej = steps = 0
    while t < limit and steps < max_steps:
        h = min(h, _F(t1) - t)
        x5, x4 = rk_step(t, x, h)
        scale = atol + rtol * torch.maximum(x.abs(), x5.abs())
        err = _F(torch.sqrt(torch.mean(((x5 - x4) / scale) ** 2)).item())
        accept = bool(err <= 1.0)
        factor = _F(np.clip(_F(0.9) * (_F(1.0) / max(err, _F(1e-12))) ** _F(0.2),
                            _F(0.2), _F(5.0)))
        h_new = _F(h * factor)
        if accept:
            t, x = _F(t + h), x5
        acc += accept
        rej += not accept
        h = max(h_new, _F(1e-8))
        steps += 1
    return RK45Result(x1=x, nfe=7 * steps, accepted=acc, rejected=rej)
