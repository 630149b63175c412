"""Solver taxonomy engine (Theorem 3.2, Figure 3).

Port of ``repro.core.taxonomy``. Every solver used to sample diffusion/flow
models — generic RK/multistep, exponential integrators (DDIM/DPM++), EDM, and
Scale-Time solvers — has update rules that are *linear* in the trajectory
points and the model's velocity evaluations. Theorem 3.2 says they are
therefore all members of the Non-Stationary family.

Solver "programs" are written once against an abstract linear-algebra
backend, and running a program under

  * ``NumericBackend``  — executes the solver directly on tensors;
  * ``SymbolicBackend`` — tracks every point as ``a * x0 + sum_j b_j u_j``
    and emits the canonical NS parameters (Prop. 3.1) of that very solver.

``to_ns(program, ...)`` is then the constructive proof of the inclusion. The
symbolic coefficients are float32 scalars combined in the reference's order,
so the port's NS parameters equal the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Protocol, Sequence

import torch

from repro_torch.core.ns_solver import NSParams
from repro_torch.core.parametrization import VelocityField

Tensor = torch.Tensor


def _f32(x) -> Tensor:
    """A float32 scalar, rounded from a Python/numpy number as jnp.asarray does."""
    if isinstance(x, Tensor):
        return x.to(torch.float32)
    return torch.tensor(float(x), dtype=torch.float32)


# ---------------------------------------------------------------------------
# Backends
# ---------------------------------------------------------------------------


class Backend(Protocol):
    def initial(self): ...
    def eval_u(self, t, point): ...
    def combine(self, terms: Sequence[tuple[Tensor, object]]): ...
    def finalize(self, point): ...


@dataclasses.dataclass
class NumericBackend:
    """Runs a solver program directly on tensors (the 'oracle' execution)."""

    field: VelocityField
    x0: Tensor
    input_scale: Tensor | float = 1.0
    output_scale: Tensor | float = 1.0
    result: Tensor | None = None
    nfe: int = 0

    def initial(self):
        return self.input_scale * self.x0

    def eval_u(self, t, point):
        self.nfe += 1
        return self.field.fn(_f32(t).to(point.device), point)

    def combine(self, terms):
        out = None
        for c, p in terms:
            contrib = c * p
            out = contrib if out is None else out + contrib
        return out

    def finalize(self, point):
        self.result = self.output_scale * point
        return self.result


@dataclasses.dataclass(frozen=True)
class Lin:
    """a * x0 + sum_j b_j u_j, coefficients are float32 scalars."""

    a: Tensor
    b: tuple[Tensor, ...]

    def scaled(self, c) -> "Lin":
        return Lin(a=c * self.a, b=tuple(c * bj for bj in self.b))


def _lin_add(x: Lin, y: Lin) -> Lin:
    k = max(len(x.b), len(y.b))

    def pad(b):
        return b + (_f32(0.0),) * (k - len(b))

    xb, yb = pad(x.b), pad(y.b)
    return Lin(a=x.a + y.a, b=tuple(xj + yj for xj, yj in zip(xb, yb)))


@dataclasses.dataclass
class SymbolicBackend:
    """Tracks solver points symbolically and emits NS parameters.

    NS structural invariant: every model evaluation must happen at the point
    produced by the previous update rule (or at x0 for the first). The
    backend enforces this by registering each eval's point as the next
    trajectory point.
    """

    input_scale: Tensor | float = 1.0
    output_scale: Tensor | float = 1.0

    def __post_init__(self):
        self.times: list[Tensor] = []
        self.updates: list[Lin] = []  # Lin for x_1, ..., x_n
        self._initial = Lin(a=_f32(self.input_scale), b=())

    def initial(self) -> Lin:
        return self._initial

    def eval_u(self, t, point: Lin) -> Lin:
        i = len(self.times)
        if i > 0:
            # point becomes trajectory point x_i = output of update rule i-1.
            self.updates.append(point)
        self.times.append(_f32(t))
        b = (_f32(0.0),) * i + (_f32(1.0),)
        return Lin(a=_f32(0.0), b=b)

    def combine(self, terms) -> Lin:
        out = None
        for c, p in terms:
            contrib = p.scaled(_f32(c))
            out = contrib if out is None else _lin_add(out, contrib)
        return out

    def finalize(self, point: Lin) -> Lin:
        final = point.scaled(_f32(self.output_scale))
        self.updates.append(final)
        return final

    def ns_params(self) -> NSParams:
        n = len(self.times)
        if len(self.updates) != n:
            raise ValueError(
                f"program registered {len(self.updates)} updates for {n} evals; "
                "every eval must consume the previous update's output")
        times = torch.stack(self.times)
        a = torch.stack([up.a for up in self.updates])
        b = torch.zeros((n, n), dtype=torch.float32)
        for i, up in enumerate(self.updates):
            if len(up.b) > i + 1:
                raise ValueError(f"update {i} uses future velocities")
            for j, bj in enumerate(up.b):
                b[i, j] = bj
        return NSParams(times=times, a=a, b=b)


# ---------------------------------------------------------------------------
# Conversion entry points
# ---------------------------------------------------------------------------

Program = Callable[..., None]


def to_ns(program: Program, *args, input_scale=1.0, output_scale=1.0, **kwargs) -> NSParams:
    """Run ``program`` symbolically; return its canonical NS parameters (CPU, f32)."""
    be = SymbolicBackend(input_scale=input_scale, output_scale=output_scale)
    program(be, *args, **kwargs)
    return be.ns_params()


def run_direct(
    program: Program,
    field: VelocityField,
    x0: Tensor,
    *args,
    input_scale=1.0,
    output_scale=1.0,
    **kwargs,
) -> Tensor:
    """Run ``program`` numerically (the solver's direct implementation)."""
    be = NumericBackend(field=field, x0=x0, input_scale=input_scale,
                        output_scale=output_scale)
    program(be, *args, **kwargs)
    if be.result is None:
        raise ValueError("program did not call finalize")
    return be.result
