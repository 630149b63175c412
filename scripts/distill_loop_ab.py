#!/usr/bin/env python3
"""Phase 12's training loop in two checkouts, on one card in one process.

    PYTHONPATH=src python3 scripts/distill_loop_ab.py OTHER_CHECKOUT

Loads ``OTHER_CHECKOUT/src/repro_torch/core/bns.py`` beside this checkout's
``core/bns.py``; its imports resolve to this checkout's modules, so only the
loop's own code differs. Builds yi-6b at full width (bf16 weights, random
from a seeded generator on the card), the launcher's distillation field
(``velocity_field(..., remat=True)``) over batch 4, seq 1024, and one train
and one val pair set drawn on the card from a seeded generator (no RK45:
the pairs' values do not change the work). Then ``train_bns`` with
``chip_smoke.py`` phase 12's config (euler NFE 8, lr 1e-3 cosine, 8
iterations, full batches, one validation at the end) in the order other,
this, this-synced, this-synced, this, other, after one warm-up iteration.
``this-synced`` runs this checkout's loop eagerly (``programs.disabled()``:
a graph cannot hold a synchronisation) and adds a
``torch.cuda.synchronize()`` after ``adam_init`` and after each
iteration's ``adam_update_``; ``this`` runs it as on the card by default
(one captured step, replayed). Each run's ms an iteration is
phase 12's: (``train_bns`` wall after a synchronise − one validation) / 8,
the validation (``ns_sample`` under no_grad and the PSNR) timed alone
first; this checkout's runs also print ``bns.fit``'s per-iteration times.
Prints the card's name and power limit first. Needs one card.
"""
from __future__ import annotations

import contextlib
import importlib.util
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

BATCH, SEQ, NFE, ITERS = 4, 1024, 8, 8   # chip_smoke.py's phase 12


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__.split("\n\n")[1], file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("distill_loop_ab: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.core import bns, ns_solver
    from repro_torch.core.schedulers import get_scheduler
    from repro_torch.data.synthetic import DataConfig, SyntheticTokens
    from repro_torch.kernels import build
    from repro_torch.models import model as M
    from repro_torch.serving import programs
    from repro_torch.solvers import build_ns

    path = Path(sys.argv[1]) / "src" / "repro_torch" / "core" / "bns.py"
    spec = importlib.util.spec_from_file_location("other_bns", path)
    other = sys.modules["other_bns"] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(other)

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True, capture_output=True,
                         text=True).stdout.strip())
    build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = get_config("yi-6b")
    params = M.init_params(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    cond = SyntheticTokens(cfg, DataConfig(batch_size=BATCH, seq_len=SEQ, seed=0),
                           device=dev).batch(0)
    field = M.velocity_field(params, cfg, get_scheduler("fm_ot"), cond, remat=True)
    g = torch.Generator(device=dev).manual_seed(1)
    x0t, x1t, x0v, x1v = (torch.randn((BATCH, SEQ, cfg.latent_dim), generator=g, device=dev)
                          for _ in range(4))

    def train(module, iterations=ITERS):
        tc = module.BNSTrainConfig(nfe=NFE, init_solver="euler", lr=1e-3,
                                   lr_schedule="cosine", iterations=iterations,
                                   val_every=100, batch_size=BATCH)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = module.train_bns(field, (x0t, x1t), (x0v, x1v), tc)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, res

    def synced(fn):
        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            return out
        return call

    train(bns, iterations=1)                               # the process's first backward
    theta = build_ns("euler", NFE, None)
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        float(torch.mean(bns.psnr(ns_solver.ns_sample(theta, field.fn, x0v), x1v)))
        val_s = time.perf_counter() - t0
    print(f"one validation {val_s * 1e3:.1f} ms")
    inner = (bns.adam_init, bns.adam_update_)
    for name in ("other", "this", "this-synced", "this-synced", "this", "other"):
        if name == "this-synced":
            bns.adam_init, bns.adam_update_ = (synced(fn) for fn in inner)
        with (programs.disabled() if name == "this-synced" else contextlib.nullcontext()):
            wall, res = train(other if name == "other" else bns)
        bns.adam_init, bns.adam_update_ = inner
        each = ("" if name == "other" else
                f"; each {[round(s * 1e3, 1) for s in res.iteration_seconds]}")
        print(f"{name}: train_bns {wall:.3f} s, {(wall - val_s) / ITERS * 1e3:.1f} ms an "
              f"iteration, losses {[round(h[1], 5) for h in res.history]}{each}")
    print(f"yi-6b full width, euler NFE {NFE}, batch {BATCH}, seq {SEQ}, {ITERS} iterations; "
          f"peak memory {torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
