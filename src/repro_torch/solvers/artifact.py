"""SolverArtifact — the <200-parameter solver as a serializable product.

Port of ``repro.solvers.artifact``: the ``SolverSpec``, the trained
parameters, the validation PSNR they earned and free-form provenance, in one
``.msgpack`` file written by ``checkpoint.checkpointer`` (msgpack leaves of
numpy bytes + JSON meta). The format is the reference's: an artifact either
package writes loads in the other with bit-equal parameters, and the same
solver and meta give the same bytes. Kinds: ``ns``, ``bns``, ``bst`` and
``anytime``; a ``bst`` artifact's ``ns_params`` raises ``TypeError`` (its
solver runs through ``bns.bst_sampler``), as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.checkpoint import checkpointer
from repro_torch.core import anytime as anytime_mod
from repro_torch.core import bst_solver, ns_solver
from repro_torch.core.ns_solver import NSParams
from repro_torch.core.parametrization import VelocityField
from repro_torch.solvers.pipeline import Sampler
from repro_torch.solvers.spec import SolverSpec, ns_at_budget, reduce_to_ns

FORMAT = "bns-solver-artifact"
FORMAT_VERSION = 1

_KINDS = {
    NSParams: "ns",
    ns_solver.BNSParams: "bns",
    bst_solver.BSTParams: "bst",
    anytime_mod.AnytimeParams: "anytime",
}


def _param_template(kind: str, spec: SolverSpec):
    """Zero f32 tree with the shapes ``spec`` implies, for checkpoint restore."""
    n = spec.nfe
    z = torch.zeros
    if kind == "ns":
        return NSParams(times=z((n,)), a=z((n,)), b=z((n, n)))
    if kind == "bns":
        return ns_solver.BNSParams(time_logits=z((n,)), a=z((n,)), b=z((n, n)))
    if kind == "bst":
        k = bst_solver.knot_positions(n, spec.name).shape[0]
        return bst_solver.BSTParams(time_logits=z((k - 1,)), log_s=z((k,)),
                                    log_dt=z((k,)), ds=z((k,)))
    if kind == "anytime":
        m = len(spec.budgets) - 1
        return anytime_mod.AnytimeParams(time_raw=z((n,)), a=z((n,)), b=z((n, n)),
                                         exit_a=z((m,)), exit_b=z((m, n)))
    raise ValueError(f"unknown artifact param kind {kind!r}")


@dataclasses.dataclass
class SolverArtifact:
    """spec + trained params + val PSNR + provenance, in one file."""

    spec: SolverSpec
    params: Any
    val_psnr: float
    provenance: dict = dataclasses.field(default_factory=dict)

    @property
    def kind(self) -> str:
        try:
            return _KINDS[type(self.params)]
        except KeyError:
            raise TypeError(
                f"unsupported artifact params {type(self.params).__name__}")

    @property
    def ns_params(self) -> NSParams:
        """Canonical NS parameters for Algorithm-1 serving."""
        return reduce_to_ns(self.params)

    @property
    def budgets(self) -> tuple[int, ...]:
        """NFE budgets this artifact serves (a single one unless anytime)."""
        return self.spec.budgets or (self.spec.nfe,)

    def ns_at_budget(self, m: int) -> NSParams:
        """The m-step NS solver served at budget ``m``: an anytime artifact's
        m-step early-exit solver; a single-budget artifact's own, which must
        have m steps."""
        return ns_at_budget(self.params, self.budgets, m)

    def nearest_budget(self, m: int) -> int:
        """The served budget closest to ``m`` (ties break to the smaller —
        fewer backbone forwards)."""
        return min(self.budgets, key=lambda b: (abs(b - m), b))

    def sampler(self, field: VelocityField, update_fn=None,
                budget: Optional[int] = None) -> Sampler:
        """Session sampling the artifact's solver on ``field``; ``budget``
        selects the early exit of an anytime artifact (default: the top
        budget)."""
        if budget is None and self.kind == "anytime":
            budget = self.budgets[-1]
        ns = self.ns_params if budget is None else self.ns_at_budget(budget)
        return Sampler(ns, field, update_fn=update_fn)

    def save(self, path: str) -> None:
        meta = {"format": FORMAT, "version": FORMAT_VERSION,
                "kind": self.kind, "spec": self.spec.to_dict(),
                "val_psnr": float(self.val_psnr),
                "provenance": self.provenance}
        checkpointer.save(path, self.params, meta=meta)

    @classmethod
    def load(cls, path: str, device: str | torch.device = "cpu") -> "SolverArtifact":
        """The artifact at ``path``, its parameters f32 on ``device``."""
        meta = checkpointer.load_meta(path)
        if meta is None or meta.get("format") != FORMAT:
            raise ValueError(f"{path} is not a solver artifact")
        spec = SolverSpec.from_dict(meta["spec"])
        template = _param_template(meta["kind"], spec)
        params = checkpointer.restore(path, template, device)
        return cls(spec=spec, params=params,
                   val_psnr=float(meta["val_psnr"]),
                   provenance=dict(meta.get("provenance", {})))


def save_artifact(path: str, trained, provenance: Optional[dict] = None) -> "SolverArtifact":
    """Convenience: wrap a ``TrainedSolver`` and write it in one call."""
    art = trained.artifact(provenance)
    art.save(path)
    return art
