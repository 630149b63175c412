"""Quickstart on the port: distill a BNS solver for an analytic flow model.

  PYTHONPATH=src python examples/torch/quickstart.py [--device cpu]

The twin of ``examples/quickstart.py`` on ``repro_torch``:
  1. take a 'pre-trained' flow model — the exact mixture velocity field;
  2. generate (noise, sample) pairs with adaptive RK45 (the GT sampler);
  3. score every registered baseline solver (list_solvers) in NS form;
  4. optimize a Bespoke Non-Stationary solver (Algorithm 2) at NFE=8;
  5. print the PSNR leaderboard — BNS should win by several dB.

Runs on the card unless ``--device cpu`` is given (exits non-zero without
one); the noise comes from seeded ``torch.Generator``s. ``--pairs`` and
``--iterations`` cut the run (defaults: the reference's 256 and 800).
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import resolve_device
from repro_torch.core import ns_solver, schedulers, toy
from repro_torch.core.bns import BNSTrainConfig, generate_pairs
from repro_torch.solvers import SolverSpec, list_solvers

NFE = 8


def mixture(device) -> object:
    """The two-moons mixture field under fm_ot (16 components of std 0.15)."""
    sched = schedulers.fm_ot()
    return toy.mixture_field(sched, toy.two_moons_means().to(device),
                             torch.full((16,), 0.15, device=device),
                             torch.ones((16,), device=device))


def baseline_scores(field, val, nfe: int = NFE) -> dict[str, float]:
    """Every registered baseline's PSNR on ``val`` at ``nfe``."""
    return {info.name: SolverSpec(info.name, nfe).sampler(field).psnr(val)
            for info in list_solvers(baseline=True)}


def main(argv=None) -> dict[str, float]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--pairs", type=int, default=256)
    ap.add_argument("--iterations", type=int, default=800)
    args = ap.parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(str(e)) from None
    field = mixture(dev)

    print("generating RK45 ground-truth pairs...")
    train = generate_pairs(field, torch.Generator(device=dev).manual_seed(0), args.pairs, (2,))
    val = generate_pairs(field, torch.Generator(device=dev).manual_seed(1), args.pairs, (2,))

    scores = baseline_scores(field, val)

    print(f"training BNS solver (NFE={NFE}, "
          f"{ns_solver.count_parameters(NFE)} parameters)...")
    spec = SolverSpec("midpoint", NFE, mode="bns")
    res = spec.distill(field, train, val,
                       BNSTrainConfig(iterations=args.iterations,
                                      val_every=min(100, args.iterations), batch_size=64),
                       log=lambda m: print("  " + m))
    scores["BNS (ours)"] = res.val_psnr

    print(f"\nPSNR @ {NFE} NFE (vs RK45 ground truth):")
    for name, s in sorted(scores.items(), key=lambda kv: kv[1]):
        print(f"  {name:12s} {s:6.2f} dB")
    assert scores["BNS (ours)"] == max(scores.values())
    print("\nBNS wins — the paper's headline result, reproduced.")
    return scores


if __name__ == "__main__":
    main()
