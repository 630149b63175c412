#!/usr/bin/env python3
"""Where a distillation iteration's time goes on the card, eager and graphed:
each Algorithm-2 iteration of the BNS, anytime and BST trainers timed alone,
and a ``torch.profiler`` trace of one, both ways.

    PYTHONPATH=src python3 scripts/distill_step_profile.py [--seqs 256 1024] [--iters 4]

Builds yi-6b at full width (bf16 weights, random from a seeded generator on
the card) and, for each sequence length, the launcher's distillation field
(``velocity_field(..., remat=True)``, batch 4) with x0, x1 drawn on the card
from a seeded generator (no RK45: the pairs' values do not change the work).
Each trainer's iteration is ``bns.TrainLoop.step()`` (the mini-batch, the
loss, ``torch.autograd.grad`` in theta and Adam in place): ``bns`` is the
euler NFE-8 solver (``train_bns``'s loss), ``anytime`` the nested solver
over budgets (4, 8) (``train_anytime``'s), ``bst`` BST-Euler at NFE 8
(``train_bst``'s). Each runs ``--iters`` iterations eager (under
``programs.disabled()``) and then graphed (a fresh loop: its first
iteration is the capture's warm-up, every later one a replay), each timed
on the host clock after ``torch.cuda.synchronize()``, the first printed
apart; then one more iteration under the profiler: its wall time, the
device's busy ms and share (the union of the kernels' intervals), the host's
launches (kernels, graphs, copies and fills) and the operators that take
the most device time. Prints the card's name and power limit first. Needs
one card.
"""
from __future__ import annotations

import argparse
import contextlib
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from decode_profile import busy_ms, host_launches  # noqa: E402

BATCH = 4   # the flow cell's batch (chip_smoke.py's phases 12 and 12c)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seqs", type=int, nargs="+", default=[256, 1024])
    ap.add_argument("--iters", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("distill_step_profile: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.core import anytime, bns, bst_solver, ns_solver
    from repro_torch.core.schedulers import get_scheduler
    from repro_torch.data.synthetic import DataConfig, SyntheticTokens
    from repro_torch.kernels import build
    from repro_torch.models import model as M
    from repro_torch.serving import programs
    from repro_torch.solvers import build_ns

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True, capture_output=True,
                         text=True).stdout.strip())
    build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = get_config("yi-6b")
    params = M.init_params(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    for seq in args.seqs:
        cond = SyntheticTokens(cfg, DataConfig(batch_size=BATCH, seq_len=seq, seed=0),
                               device=dev).batch(0)
        field = M.velocity_field(params, cfg, get_scheduler("fm_ot"), cond, remat=True)
        g = torch.Generator(device=dev).manual_seed(1)
        x0, x1 = (torch.randn((BATCH, seq, cfg.latent_dim), generator=g, device=dev)
                  for _ in "01")
        tc = bns.BNSTrainConfig(nfe=8, lr=1e-3, lr_schedule="cosine",
                                iterations=args.iters + 1, val_every=100, batch_size=BATCH)
        loops = {
            "bns": lambda: bns.TrainLoop(
                *bns.solver_objective(bns.ns_sampler(field), (x0, x1), tc),
                ns_solver.from_ns(build_ns("euler", 8, None)), (x0, x1), tc),
            "anytime": lambda: bns.TrainLoop(
                *anytime.anytime_objective(field, (4, 8), (x0, x1), tc),
                anytime.init_anytime(None, (4, 8)), (x0, x1), tc),
            "bst": lambda: bns.TrainLoop(
                *bns.solver_objective(bns.bst_sampler(field), (x0, x1), tc),
                bst_solver.identity_bst(8, "euler"), (x0, x1), tc)}
        for name, make in loops.items():
            for way in ("eager", "graphed"):
                loop = make()
                with (programs.disabled() if way == "eager" else contextlib.nullcontext()):
                    walls = []
                    for _ in range(args.iters):
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        loop.step()
                        torch.cuda.synchronize()
                        walls.append((time.perf_counter() - t0) * 1e3)
                    acts = [torch.profiler.ProfilerActivity.CPU,
                            torch.profiler.ProfilerActivity.CUDA]
                    with torch.profiler.profile(activities=acts) as prof:
                        t0 = time.perf_counter()
                        loop.step()
                        torch.cuda.synchronize()
                        wall = (time.perf_counter() - t0) * 1e3
                busy = busy_ms(prof.events())
                launches = host_launches(prof.events(), 1)
                print(f"{name} iteration, {way}, yi-6b full width, batch {BATCH}, seq {seq}: "
                      f"ms {[round(w, 1) for w in walls]} (first {walls[0]:.1f}, then mean "
                      f"{sum(walls[1:]) / max(1, len(walls) - 1):.1f}); profiled {wall:.1f} ms, "
                      f"device busy {busy:.1f} ms ({100 * busy / wall:.1f}%); host launches "
                      f"{ {k: int(v) for k, v in launches.items()} }; capture "
                      f"{loop.programs.capture_ms:.1f} ms; peak memory "
                      f"{torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB", flush=True)
                print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=8,
                                                max_name_column_width=50))
                del loop
                torch.cuda.reset_peak_memory_stats(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
