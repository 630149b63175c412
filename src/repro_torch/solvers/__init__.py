"""Solver product API (port of ``repro.solvers``): registry / spec / artifact
/ pipeline.

    spec = SolverSpec("midpoint", nfe=8, mode="bns")
    art = spec.distill(field, train_pairs, val_pairs, cfg).artifact()
    art.save("solver.msgpack")   # serve: SolverArtifact.load(...).sampler(field)

``registry`` — ``@register_solver`` + capability-filtered ``list_solvers()``;
``spec``     — ``SolverSpec.build/distill`` for baseline/BNS/BST/anytime;
``artifact`` — serializable solver product (spec + params + PSNR +
               provenance), in the reference's file format;
``pipeline`` — ``Sampler``, the thin Algorithm-1 session.
"""
from repro_torch.solvers.artifact import SolverArtifact, save_artifact
from repro_torch.solvers.pipeline import Sampler, evaluate_psnr
from repro_torch.solvers.registry import (
    SolverInfo,
    build_ns,
    get_solver,
    list_solvers,
    register_solver,
    solver_names,
)
from repro_torch.solvers.spec import (
    MODES,
    SolverSpec,
    TrainedSolver,
    ns_at_budget,
    reduce_to_ns,
)

__all__ = [
    "MODES", "Sampler", "SolverArtifact", "SolverInfo", "SolverSpec",
    "TrainedSolver", "build_ns", "evaluate_psnr", "get_solver",
    "list_solvers", "ns_at_budget", "reduce_to_ns", "register_solver",
    "save_artifact", "solver_names",
]
