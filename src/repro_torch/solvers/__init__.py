"""Solver product API: the registry of named solvers (``SolverSpec`` and
``SolverArtifact`` come with ROADMAP Queue A item 3)."""
from repro_torch.solvers.registry import (
    SolverInfo,
    build_ns,
    get_solver,
    list_solvers,
    register_solver,
    solver_names,
)

__all__ = ["SolverInfo", "build_ns", "get_solver", "list_solvers",
           "register_solver", "solver_names"]
