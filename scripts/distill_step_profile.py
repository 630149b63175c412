#!/usr/bin/env python3
"""Where a distillation iteration's time goes on the card: each iteration of
the BNS and the anytime loss's gradient timed alone, and a ``torch.profiler``
trace of one.

    PYTHONPATH=src python3 scripts/distill_step_profile.py [--seqs 256 1024] [--iters 4]

Builds yi-6b at full width (bf16 weights, random from a seeded generator on
the card) and, for each sequence length, the launcher's distillation field
(``velocity_field(..., remat=True)``, batch 4) with x0, x1 drawn on the card
from a seeded generator (no RK45: the pairs' values do not change the work).
Then ``--iters`` iterations of each gradient: ``bns._loss_fn`` of the euler
NFE-8 solver (``train_bns``'s) and ``anytime.anytime_loss`` of the nested
solver over budgets (4, 8) (``train_anytime``'s), each the loss and
``torch.autograd.grad`` in theta, timed on the host clock after
``torch.cuda.synchronize()``; the first iteration of each is printed apart.
One more iteration of each runs under the profiler: its wall time, the
device's busy share of it (the union of the kernels' intervals), and the
operators that take the most device and host time. Prints the card's name
and power limit first. Needs one card.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from decode_profile import busy_ms  # noqa: E402

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
    from repro_torch.core import anytime, bns, ns_solver
    from repro_torch.core.schedulers import get_scheduler
    from repro_torch.data.synthetic import DataConfig, SyntheticTokens
    from repro_torch.kernels import build
    from repro_torch.models import model as M
    from repro_torch.solvers import build_ns

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True, capture_output=True,
                         text=True).stdout.strip())
    build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = get_config("yi-6b")
    params = M.init_params(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    thetas = {"bns": ns_solver.from_ns(build_ns("euler", 8, None)),
              "anytime": anytime.init_anytime(None, (4, 8))}
    for seq in args.seqs:
        cond = SyntheticTokens(cfg, DataConfig(batch_size=BATCH, seq_len=seq, seed=0),
                               device=dev).batch(0)
        field = M.velocity_field(params, cfg, get_scheduler("fm_ot"), cond, remat=True)
        g = torch.Generator(device=dev).manual_seed(1)
        x0, x1 = (torch.randn((BATCH, seq, cfg.latent_dim), generator=g, device=dev)
                  for _ in "01")
        losses = {"bns": lambda th: bns._loss_fn(bns.ns_sampler(field), th, x0, x1),
                  "anytime": lambda th: anytime.anytime_loss(th, (4, 8), field.fn, x0, x1)}
        for name, loss_fn in losses.items():
            leaves = [p.to(dev) for p in thetas[name]]

            def step():
                th = type(thetas[name])(*(p.detach().requires_grad_(True) for p in leaves))
                loss = loss_fn(th)
                torch.autograd.grad(loss, list(th))

            walls = []
            for _ in range(args.iters):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step()
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                t0 = time.perf_counter()
                step()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            busy = busy_ms(prof.events())
            print(f"{name} gradient, yi-6b full width, batch {BATCH}, seq {seq}: iteration "
                  f"ms {[round(w, 1) for w in walls]} (first {walls[0]:.1f}, then mean "
                  f"{sum(walls[1:]) / max(1, len(walls) - 1):.1f}); profiled {wall:.1f} ms, "
                  f"device busy {busy:.1f} ms ({100 * busy / wall:.1f}%); peak memory "
                  f"{torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB")
            print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=12,
                                            max_name_column_width=60))
            print(prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=10,
                                            max_name_column_width=60))
            torch.cuda.reset_peak_memory_stats(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
