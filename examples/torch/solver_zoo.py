"""Taxonomy tour on the port (Theorem 3.2 live): run every named solver family
directly AND as its NS-converted form, showing exact agreement — Euler,
Midpoint, Heun, RK4, Adams-Bashforth, DDIM, DPM++(2M), EDM, sigma0-
preconditioned ST, and a perturbed BST solver.

  PYTHONPATH=src python examples/torch/solver_zoo.py [--device cpu]

The twin of ``examples/solver_zoo.py`` on ``repro_torch``: the NS forms run
through ``ns_sample`` (the ``ns_update`` kernel on the card). Runs on the card
unless ``--device cpu`` is given (exits non-zero without one); x0 comes from
a seeded ``torch.Generator``.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import resolve_device
from repro_torch.core import ns_solver, schedulers, solvers, st_solvers, st_transform, taxonomy, toy
from repro_torch.core.bst_solver import bst_euler_program, identity_bst, materialize_bst
from repro_torch.core.exponential import ddim_program, dpm2m_program, exp_grid
from repro_torch.solvers import list_solvers


def mixture(device):
    """The two-moons mixture field under vp (16 components of std 0.15)."""
    sched = schedulers.vp()
    return toy.mixture_field(sched, toy.two_moons_means().to(device),
                             torch.full((16,), 0.15, device=device),
                             torch.ones((16,), device=device))


def cases(sched) -> list[tuple]:
    """(name, family, program, program args) for every row of the table."""
    out = []
    for name in ["euler", "midpoint", "heun", "rk4", "ab2", "ab4"]:
        out.append((name, "generic (RK/multistep)", solvers.solver_program(name),
                    (solvers.grid_for_nfe(name, 8),)))
    out.append(("ddim", "exponential (1st)", ddim_program, (exp_grid(sched, 8), sched)))
    out.append(("dpm++(2M)", "exponential multistep", dpm2m_program,
                (exp_grid(sched, 8), sched)))
    out.append(("edm+heun", "scale-time (VE)",
                st_solvers.edm_program(solvers.heun_program, sched, 20.0),
                (solvers.power_grid(4, 3.0),)))
    st = st_transform.scheduler_change_st(sched, schedulers.scaled_sigma(sched, 3.0))
    out.append(("precond-euler s0=3", "scale-time",
                st_solvers.st_program(solvers.euler_program, st), (solvers.uniform_grid(8),)))
    out.append(("bst-euler", "bespoke scale-time", bst_euler_program,
                (materialize_bst(identity_bst(8)),)))
    return out


@torch.no_grad()
def rows(field, x0) -> list[dict]:
    """Each case run directly and through its NS form from ``x0``: the NS
    output, its step count and the largest |direct - NS|."""
    out = []
    for name, family, prog, args in cases(field.scheduler):
        direct = taxonomy.run_direct(prog, field, x0, *args)
        ns = taxonomy.to_ns(prog, *args)
        alg1 = ns_solver.ns_sample(ns, field.fn, x0)
        out.append(dict(name=name, family=family, n=ns.n, ns=alg1,
                        err=float(torch.max(torch.abs(direct - alg1)))))
    return out


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(str(e)) from None
    field = mixture(dev)
    x0 = torch.randn((16, 2), generator=torch.Generator(device=dev).manual_seed(0), device=dev)

    print(f"{'solver':20s} {'family':22s} {'n':>3s} {'max |direct-NS|':>16s}")
    table = rows(field, x0)
    for r in table:
        print(f"{r['name']:20s} {r['family']:22s} {r['n']:3d} {r['err']:16.2e}")
    print("\nEvery family is a point in the Non-Stationary space (Fig. 3) — "
          "BNS optimizes over all of them at once.")

    print(f"\nregistry ({len(list_solvers())} solvers): "
          f"{'name':12s} {'family':14s} sigma0  grid")
    for info in list_solvers():
        print(f"  {info.name:12s} {info.family:14s} "
              f"{'yes' if info.supports_sigma0 else 'no ':3s}    "
              f"{info.grid_family}")
    return table


if __name__ == "__main__":
    main()
