"""Figure 4 / Table 4 reproduction (analytic-teacher scale): PSNR vs NFE for
BNS against BST and every baseline solver family, across the paper's three
pre-trained-model types (FM-OT, FM/v-CS, eps-VP schedulers).

Port of ``benchmarks/psnr_vs_nfe.py``:

    PYTHONPATH=src python -m repro_torch.benchmarks.psnr_vs_nfe            # the card
    PYTHONPATH=src python -m repro_torch.benchmarks.psnr_vs_nfe --device cpu

Expected (paper): BNS > BST > DPM > RK-Midpoint/Euler in PSNR at low NFE, and
PSNR monotone in NFE. The 'pre-trained model' is the closed-form
Gaussian-mixture velocity field (exact marginal flow) — solver behaviour, not
network capacity, is what this figure measures. Pairs are 256 train and 256
val draws a scheduler, RK45-solved (``bns.generate_pairs`` from generators
seeded 0 and 1), unless the caller hands ``run`` its own (the tests hand it
the reference's threefry pairs). Everything runs on ``device``: the RK45
solves and the baselines' scores eagerly, the BNS and BST training through
``bns.fit``'s programs (on the card one captured step and one captured
validation, replayed; eager on the CPU). Each row's ``bns_train_s`` and
``bst_train_s`` are host-clock seconds around a distillation, whose last
validation reads the card's result.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import schedulers, toy
from repro_torch.core.bns import BNSTrainConfig, generate_pairs
from repro_torch.solvers import SolverSpec, solver_names

SCHEDS = ["fm_ot", "fm_cs", "vp"]
NFES = [4, 8, 16]
BASELINES = solver_names(baseline=True)  # euler, midpoint, ddim, dpm2m


def make_field(sname: str, device: str | torch.device = "cpu"):
    """The scheduler's mixture field, its tensors on ``device`` (where the
    state lies, so that an evaluation copies nothing from the host)."""
    sched = schedulers.get_scheduler(sname)
    return toy.mixture_field(sched, toy.two_moons_means().to(device),
                             torch.full((16,), 0.15, device=device),
                             torch.ones((16,), device=device))


def _on(pair, device):
    return tuple(torch.as_tensor(np.asarray(p) if not isinstance(p, torch.Tensor) else p,
                                 dtype=torch.float32).to(device) for p in pair)


def run(iterations: int = 3000, lr: float = 1e-3, pairs: dict | None = None,
        device: str | torch.device = "cuda", log=print) -> list[dict]:
    """One row a (scheduler, NFE): every baseline's val PSNR, then BNS
    (midpoint init) and BST (euler base) distilled with the reference's
    config. ``pairs`` maps a scheduler to its ((x0, x1) train, (x0, x1) val),
    numpy or tensors; missing schedulers draw their own."""
    dev = resolve_device(device)
    rows = []
    for sname in SCHEDS:
        field = make_field(sname, dev)
        if pairs is not None and sname in pairs:
            train, val = (_on(p, dev) for p in pairs[sname])
        else:
            train, val = (generate_pairs(field, torch.Generator(device=dev).manual_seed(s),
                                         256, (2,)) for s in (0, 1))
        for nfe in NFES:
            row = {"scheduler": sname, "nfe": nfe}
            for name in BASELINES:
                row[name] = SolverSpec(name, nfe).sampler(field).psnr(val)
            cfg = BNSTrainConfig(lr=lr, iterations=iterations, val_every=100,
                                 batch_size=64)
            t0 = time.time()
            row["bns"] = SolverSpec("midpoint", nfe, mode="bns") \
                .distill(field, train, val, cfg).val_psnr
            row["bns_train_s"] = round(time.time() - t0, 1)
            t0 = time.time()
            row["bst"] = SolverSpec("euler", nfe, mode="bst") \
                .distill(field, train, val, cfg).val_psnr
            row["bst_train_s"] = round(time.time() - t0, 1)
            rows.append(row)
            log(f"{sname} NFE={nfe}: " + " ".join(
                f"{k}={v:.2f}" for k, v in row.items()
                if isinstance(v, float) and not k.endswith("_train_s")))
    return rows


def check_paper_claims(rows: list[dict]) -> list[str]:
    """Validate the orderings the paper reports (Fig 4, Fig 11)."""
    notes = []
    for r in rows:
        runner_up = max(r[b] for b in BASELINES + ["bst"])
        # Paper Sec. 6: BNS "doesn't reach the extremely low NFE regime
        # (1-4)" — at NFE 4 we require parity with the trained-BST runner-up
        # (within 2 dB); at NFE >= 8 BNS must win outright.
        margin = 2.0 if r["nfe"] <= 4 else 0.0
        ok = r["bns"] > runner_up - margin
        notes.append(
            f"[{'PASS' if ok else 'FAIL'}] {r['scheduler']} NFE={r['nfe']}: "
            f"BNS {r['bns']:.2f} vs best-other {runner_up:.2f}"
            + (" (NFE<=4 parity band, paper Sec. 6 caveat)" if margin else ""))
        ok_bst = r["bst"] >= r["euler"] - 0.2
        notes.append(
            f"[{'PASS' if ok_bst else 'FAIL'}] {r['scheduler']} NFE={r['nfe']}: "
            f"BST {r['bst']:.2f} >= Euler {r['euler']:.2f} (trained >= init)")
    for sname in SCHEDS:
        per = [r["bns"] for r in rows if r["scheduler"] == sname]
        mono = all(b > a for a, b in zip(per, per[1:]))
        notes.append(f"[{'PASS' if mono else 'FAIL'}] {sname}: BNS PSNR "
                     f"monotone in NFE {['%.1f' % p for p in per]}")
    return notes


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.benchmarks.psnr_vs_nfe")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--json", default=None, help="write the rows and the claims here")
    args = ap.parse_args(argv)
    if args.device == "cpu":
        torch.set_num_threads(1)        # thousands of tiny eager ops a step
    t0 = time.time()
    rows = run(device=args.device)
    notes = check_paper_claims(rows)
    for n in notes:
        print(n)
    wall = time.time() - t0
    print(f"psnr_vs_nfe wall {wall:.1f} s on {args.device}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"rows": rows, "claims": notes, "wall_s": wall,
                       "device": args.device}, f, indent=1)
    return rows


if __name__ == "__main__":
    main()
