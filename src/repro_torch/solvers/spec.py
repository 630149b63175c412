"""SolverSpec — one declarative description of a solver.

Port of ``repro.solvers.spec``. A spec names a registered solver plus the
sampling configuration (NFE, grid override, sigma0 preconditioning, CFG
scale) and a ``mode``:

    baseline — the named solver as-is (no training);
    bns      — Bespoke Non-Stationary training (Algorithm 2), initialized
               from the named solver;
    bst      — Bespoke Scale-Time training (prior-work baseline), base =
               the named solver (euler | midpoint);
    anytime  — one shared solver serving every budget in ``budgets``.

``build(field)`` returns exact NS parameters; ``distill(field, ...)`` runs
the matching trainer and returns a ``TrainedSolver`` that converts to a
serializable ``SolverArtifact``. ``to_dict``/``from_dict`` are the
reference's key for key, so the spec of an artifact either package wrote is
the same value in both, and hashes the same as a ``SolverZoo`` key.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

from repro_torch.core import ns_solver
from repro_torch.core.bns import BNSTrainConfig, train_bns, train_bst
from repro_torch.core.ns_solver import NSParams
from repro_torch.core.parametrization import VelocityField
from repro_torch.solvers import registry
from repro_torch.solvers.pipeline import Sampler, evaluate_psnr

MODES = ("baseline", "bns", "bst", "anytime")


def reduce_to_ns(params) -> NSParams:
    """Canonical NS parameters of a trained/stored solver, if it has them."""
    if isinstance(params, NSParams):
        return params
    if isinstance(params, ns_solver.BNSParams):
        return ns_solver.materialize(params)
    from repro_torch.core import anytime as anytime_mod

    if isinstance(params, anytime_mod.AnytimeParams):
        raise TypeError(
            "AnytimeParams serve several budgets and do not reduce to a "
            "single NSParams; pick one with ns_at_budget(params, budgets, m) "
            "(or SolverArtifact.ns_at_budget / AnytimeFlowSampler for "
            "serving)")
    raise TypeError(f"{type(params).__name__} solvers do not reduce to a "
                    "single NSParams")


def ns_at_budget(params, budgets, m: int) -> NSParams:
    """The m-step NS solver a trained/stored solver serves at budget ``m``.

    Anytime solvers extract the bona-fide m-step early-exit solver; every
    other kind reduces to its single NSParams, which must already have
    ``m`` steps.
    """
    from repro_torch.core import anytime as anytime_mod

    if isinstance(params, anytime_mod.AnytimeParams):
        return anytime_mod.extract_ns(params, budgets, m)
    ns = reduce_to_ns(params)
    if ns.n != m:
        raise ValueError(f"solver has {ns.n} steps, not {m}; only anytime "
                         "solvers serve multiple budgets")
    return ns


@dataclasses.dataclass(frozen=True)
class SolverSpec:
    """Declarative solver description; the unit the artifact format stores."""

    name: str = "midpoint"
    nfe: int = 8
    grid: Optional[tuple[float, ...]] = None  # override the default time grid
    sigma0: float = 1.0
    cfg_scale: float = 0.0
    mode: str = "baseline"
    budgets: Optional[tuple[int, ...]] = None  # anytime mode only

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"mode {self.mode!r} not in {MODES}")
        if self.mode == "anytime":
            if not self.budgets:
                raise ValueError("anytime mode needs budgets, e.g. (4, 8, 16)")
            object.__setattr__(self, "budgets", tuple(sorted(self.budgets)))
            if self.nfe != self.budgets[-1]:
                object.__setattr__(self, "nfe", self.budgets[-1])
        if self.grid is not None:
            object.__setattr__(self, "grid", tuple(float(g) for g in self.grid))

    @property
    def info(self) -> registry.SolverInfo:
        return registry.get_solver(self.name)

    def build(self, field: Optional[VelocityField]) -> NSParams:
        """Exact NS parameters of the (baseline / init) solver for ``field``."""
        import numpy as np

        grid = None if self.grid is None else np.asarray(self.grid)
        return registry.build_ns(self.name, self.nfe, field,
                                 sigma0=self.sigma0, grid=grid)

    def sampler(self, field: VelocityField, update_fn=None) -> Sampler:
        """Baseline sampling session (no training)."""
        return Sampler(self.build(field), field, update_fn=update_fn)

    def train_config(self, base: Optional[BNSTrainConfig] = None) -> BNSTrainConfig:
        """A BNSTrainConfig with this spec's nfe/init/sigma0 pinned in."""
        base = base or BNSTrainConfig()
        return dataclasses.replace(base, nfe=self.nfe, init_solver=self.name,
                                   sigma0=self.sigma0)

    def distill(
        self,
        field: VelocityField,
        train_pairs,
        val_pairs,
        train_cfg: Optional[BNSTrainConfig] = None,
        *,
        log=None,
    ) -> "TrainedSolver":
        """Run the mode's trainer: ``train_bns``, ``train_bst`` or
        ``train_anytime`` (or no training, for a baseline)."""
        cfg = self.train_config(train_cfg)
        if self.mode == "baseline":
            params = self.build(field)
            vp = evaluate_psnr(params, field, val_pairs, cfg.max_val)
            return TrainedSolver(spec=self, params=params, val_psnr=vp,
                                 history=[], wall_seconds=0.0,
                                 num_parameters=params.num_parameters())
        if self.mode == "bns":
            res = train_bns(field, train_pairs, val_pairs, cfg, log=log)
        elif self.mode == "bst":
            if self.name not in ("euler", "midpoint"):
                raise ValueError("bst mode needs base euler or midpoint")
            res = train_bst(field, train_pairs, val_pairs, cfg,
                            base=self.name, log=log)
        else:  # anytime — imported lazily (core.anytime imports this package)
            from repro_torch.core.anytime import train_anytime

            res = train_anytime(field, list(self.budgets), train_pairs,
                                val_pairs, cfg, log=log)
        return TrainedSolver(spec=self, params=res.params,
                             val_psnr=res.val_psnr, history=res.history,
                             wall_seconds=res.wall_seconds,
                             num_parameters=res.num_parameters,
                             iteration_seconds=res.iteration_seconds)

    def to_dict(self) -> dict:
        return {"name": self.name, "nfe": self.nfe,
                "grid": list(self.grid) if self.grid is not None else None,
                "sigma0": self.sigma0, "cfg_scale": self.cfg_scale,
                "mode": self.mode,
                "budgets": list(self.budgets) if self.budgets else None}

    @classmethod
    def from_dict(cls, d: dict) -> "SolverSpec":
        return cls(name=d["name"], nfe=int(d["nfe"]),
                   grid=tuple(d["grid"]) if d.get("grid") else None,
                   sigma0=float(d.get("sigma0", 1.0)),
                   cfg_scale=float(d.get("cfg_scale", 0.0)),
                   mode=d.get("mode", "baseline"),
                   budgets=tuple(d["budgets"]) if d.get("budgets") else None)


@dataclasses.dataclass
class TrainedSolver:
    """Output of ``SolverSpec.distill``: spec + trained parameters + score."""

    spec: SolverSpec
    params: Any          # NSParams | BNSParams | BSTParams | AnytimeParams
    val_psnr: float
    history: list
    wall_seconds: float
    num_parameters: int
    iteration_seconds: list = dataclasses.field(default_factory=list)  # bns.fit's

    @property
    def ns_params(self) -> NSParams:
        """Canonical NS parameters, ready for Algorithm-1 serving."""
        return reduce_to_ns(self.params)

    @property
    def budgets(self) -> tuple[int, ...]:
        """NFE budgets this solver serves (a single one unless anytime)."""
        return self.spec.budgets or (self.spec.nfe,)

    def ns_at_budget(self, m: int) -> NSParams:
        """The m-step NS solver served at budget ``m`` (anytime early exit)."""
        return ns_at_budget(self.params, self.budgets, m)

    def sampler(self, field: VelocityField, update_fn=None) -> Sampler:
        return Sampler(self.ns_params, field, update_fn=update_fn)

    def artifact(self, provenance: Optional[dict] = None) -> "SolverArtifact":  # noqa: F821
        from repro_torch.solvers.artifact import SolverArtifact

        return SolverArtifact(spec=self.spec, params=self.params,
                              val_psnr=self.val_psnr,
                              provenance=dict(provenance or {}))
