"""Solver registry — every named solver as a self-describing entry.

Port of ``repro.solvers.registry``, holding the six generic solvers (euler,
midpoint, heun, rk4, ab2, ab4) without sigma0 preconditioning. Each entry
records its capabilities next to a ``build`` function producing the solver's
exact NS parameters (Theorem 3.2).

    build_ns("euler", 8)                   # NSParams, float32 on the CPU
    list_solvers(family="generic")         # capability-filtered enumeration

Solvers the port cannot build yet are not registered: ``build_ns`` names the
ROADMAP item that brings them.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import repro_torch.core.solvers as generic
from repro_torch.core.ns_solver import NSParams
from repro_torch.core.parametrization import VelocityField
from repro_torch.core.taxonomy import to_ns

# build(nfe, field, *, grid=None) -> NSParams
BuildFn = Callable[..., NSParams]

# Reference solvers that need exponential.py / st_transform.py / st_solvers.py.
_PENDING = {
    "ddim": "exponential integrators (core/exponential.py)",
    "dpm2m": "exponential integrators (core/exponential.py)",
    "edm_heun": "Scale-Time solvers (core/st_solvers.py)",
}
_PENDING_ITEM = "ROADMAP Queue A item 2"


@dataclasses.dataclass(frozen=True)
class SolverInfo:
    """A registered solver and its capabilities."""

    name: str
    family: str                 # "generic" (the only family ported so far)
    build: BuildFn
    evals_per_interval: int = 1
    baseline: bool = False      # include in benchmark baseline sweeps


_REGISTRY: dict[str, SolverInfo] = {}


def register_solver(
    name: str,
    *,
    family: str,
    evals_per_interval: int = 1,
    baseline: bool = False,
) -> Callable[[BuildFn], BuildFn]:
    """Decorator registering ``build(nfe, field, *, grid)`` under ``name``."""

    def deco(build: BuildFn) -> BuildFn:
        if name in _REGISTRY:
            raise ValueError(f"solver {name!r} already registered")
        _REGISTRY[name] = SolverInfo(
            name=name, family=family, build=build,
            evals_per_interval=evals_per_interval, baseline=baseline)
        return build

    return deco


def get_solver(name: str) -> SolverInfo:
    if name in _PENDING:
        raise NotImplementedError(
            f"solver {name!r} needs {_PENDING[name]}, not ported yet "
            f"({_PENDING_ITEM})")
    if name not in _REGISTRY:
        raise KeyError(f"unknown solver {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_solvers(
    *,
    family: Optional[str] = None,
    baseline: Optional[bool] = None,
) -> list[SolverInfo]:
    """Registered solvers (registration order), filtered by capability."""
    return [info for info in _REGISTRY.values()
            if (family is None or info.family == family)
            and (baseline is None or info.baseline == baseline)]


def solver_names(**filters) -> list[str]:
    return [info.name for info in list_solvers(**filters)]


def build_ns(
    name: str,
    nfe: int,
    field: Optional[VelocityField] = None,
    *,
    sigma0: float = 1.0,
    grid=None,
) -> NSParams:
    """Build the named solver's exact NS parameters (float32, on the CPU).

    The generic solvers do not depend on the field; ``field`` is accepted for
    the reference's signature.
    """
    info = get_solver(name)
    if sigma0 != 1.0:
        raise NotImplementedError(
            "sigma0 preconditioning needs the Scale-Time transform "
            f"(core/st_transform.py), not ported yet ({_PENDING_ITEM})")
    return info.build(nfe, field, grid=grid)


# ---------------------------------------------------------------------------
# Built-in solvers
# ---------------------------------------------------------------------------


def _generic_build(name: str) -> BuildFn:
    def build(nfe: int, field: Optional[VelocityField] = None, *,
              grid=None) -> NSParams:
        grid = generic.grid_for_nfe(name, nfe) if grid is None else grid
        return to_ns(generic.solver_program(name), grid)

    build.__name__ = f"build_{name}"
    return build


for _name in ("euler", "midpoint", "heun", "rk4", "ab2", "ab4"):
    register_solver(
        _name, family="generic",
        evals_per_interval=generic.evals_per_interval(_name),
        baseline=_name in ("euler", "midpoint"),
    )(_generic_build(_name))
del _name
