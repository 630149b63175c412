"""Solver registry — every named solver as a self-describing entry.

Port of ``repro.solvers.registry``. Each entry records its capabilities
(family, sigma0-preconditioning support, scheduler dependence, default grid
family) next to a ``build`` function producing the solver's exact NS
parameters (Theorem 3.2), so call sites enumerate solvers by capability
instead of hardcoding name lists.

    @register_solver("euler", family="generic", supports_sigma0=True)
    def _build_euler(nfe, field, *, sigma0=1.0, grid=None): ...

    build_ns("euler", 8, field)            # NSParams, float32 on the CPU
    list_solvers(family="generic")         # capability-filtered enumeration

The generic solvers read ``field`` only under sigma0 preconditioning (its
scheduler), so ``field=None`` builds them, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import repro_torch.core.solvers as generic
import repro_torch.core.st_solvers as st_solvers
import repro_torch.core.st_transform as st_transform
from repro_torch.core.exponential import exp_grid, exponential_program
from repro_torch.core.ns_solver import NSParams
from repro_torch.core.parametrization import VelocityField
from repro_torch.core.schedulers import scaled_sigma
from repro_torch.core.taxonomy import to_ns

# build(nfe, field, *, sigma0=1.0, grid=None) -> NSParams
BuildFn = Callable[..., NSParams]


@dataclasses.dataclass(frozen=True)
class SolverInfo:
    """A registered solver and its capabilities."""

    name: str
    family: str                 # "generic" | "exponential" | "scale-time"
    build: BuildFn
    supports_sigma0: bool = False   # accepts a sigma0-preconditioned init
    needs_scheduler: bool = False   # grid/coefficients depend on the scheduler
    grid_family: str = "uniform"    # "uniform" | "lambda" (log-SNR)
    evals_per_interval: int = 1
    baseline: bool = False          # include in benchmark baseline sweeps

    def default_grid(self, nfe: int, field: VelocityField):
        if self.grid_family == "lambda":
            return exp_grid(field.scheduler, nfe)
        return generic.grid_for_nfe(
            self.name if self.family == "generic" else "heun", nfe)

    def valid_nfe(self, nfe: int) -> bool:
        return nfe % self.evals_per_interval == 0


_REGISTRY: dict[str, SolverInfo] = {}


def register_solver(
    name: str,
    *,
    family: str,
    supports_sigma0: bool = False,
    needs_scheduler: bool = False,
    grid_family: str = "uniform",
    evals_per_interval: int = 1,
    baseline: bool = False,
) -> Callable[[BuildFn], BuildFn]:
    """Decorator registering ``build(nfe, field, *, sigma0, grid)`` under ``name``."""

    def deco(build: BuildFn) -> BuildFn:
        if name in _REGISTRY:
            raise ValueError(f"solver {name!r} already registered")
        _REGISTRY[name] = SolverInfo(
            name=name, family=family, build=build,
            supports_sigma0=supports_sigma0, needs_scheduler=needs_scheduler,
            grid_family=grid_family, evals_per_interval=evals_per_interval,
            baseline=baseline)
        return build

    return deco


def get_solver(name: str) -> SolverInfo:
    if name not in _REGISTRY:
        raise KeyError(f"unknown solver {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_solvers(
    *,
    family: Optional[str] = None,
    baseline: Optional[bool] = None,
    supports_sigma0: Optional[bool] = None,
) -> list[SolverInfo]:
    """Registered solvers (registration order), filtered by capability."""
    return [info for info in _REGISTRY.values()
            if (family is None or info.family == family)
            and (baseline is None or info.baseline == baseline)
            and (supports_sigma0 is None or info.supports_sigma0 == supports_sigma0)]


def solver_names(**filters) -> list[str]:
    return [info.name for info in list_solvers(**filters)]


def build_ns(
    name: str,
    nfe: int,
    field: Optional[VelocityField],
    *,
    sigma0: float = 1.0,
    grid=None,
) -> NSParams:
    """Build the named solver's exact NS parameters for ``field`` (float32,
    on the CPU).

    The returned parameters sample the ORIGINAL field via Algorithm 1 — any
    sigma0-preconditioning ST transform is absorbed into the coefficients.
    """
    info = get_solver(name)
    if sigma0 != 1.0 and not info.supports_sigma0:
        raise ValueError(
            f"{name!r} does not support sigma0 preconditioning "
            "(precondition exponential solvers via their own scheduler)")
    return info.build(nfe, field, sigma0=sigma0, grid=grid)


# ---------------------------------------------------------------------------
# Built-in solvers
# ---------------------------------------------------------------------------


def _generic_build(name: str) -> BuildFn:
    def build(nfe: int, field: Optional[VelocityField], *, sigma0: float = 1.0,
              grid=None) -> NSParams:
        grid = generic.grid_for_nfe(name, nfe) if grid is None else grid
        prog = generic.solver_program(name)
        if sigma0 != 1.0:
            target = scaled_sigma(field.scheduler, sigma0)
            st = st_transform.scheduler_change_st(field.scheduler, target)
            return to_ns(st_solvers.st_program(prog, st), grid)
        return to_ns(prog, grid)

    build.__name__ = f"build_{name}"
    return build


for _name in ("euler", "midpoint", "heun", "rk4", "ab2", "ab4"):
    register_solver(
        _name, family="generic", supports_sigma0=True,
        evals_per_interval=generic.evals_per_interval(_name),
        baseline=_name in ("euler", "midpoint"),
    )(_generic_build(_name))
del _name


def _exponential_build(name: str) -> BuildFn:
    # sigma0 support is enforced centrally by build_ns (supports_sigma0=False)
    def build(nfe: int, field: VelocityField, *, sigma0: float = 1.0,
              grid=None) -> NSParams:
        if grid is None:
            grid = exp_grid(field.scheduler, nfe)
        return to_ns(exponential_program(name), grid, field.scheduler)

    build.__name__ = f"build_{name}"
    return build


for _name in ("ddim", "dpm2m"):
    register_solver(
        _name, family="exponential", needs_scheduler=True,
        grid_family="lambda", baseline=True,
    )(_exponential_build(_name))
del _name


@register_solver("edm_heun", family="scale-time", needs_scheduler=True,
                 evals_per_interval=2)
def _build_edm_heun(nfe: int, field: VelocityField, *, sigma0: float = 1.0,
                    grid=None) -> NSParams:
    grid = generic.grid_for_nfe("heun", nfe) if grid is None else grid
    prog = st_solvers.edm_program(generic.heun_program, field.scheduler)
    return to_ns(prog, grid)
