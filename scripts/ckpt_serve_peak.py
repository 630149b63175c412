#!/usr/bin/env python3
"""Device memory of ``serve --ckpt`` at full width and depth.

    PYTHONPATH=src python3 scripts/ckpt_serve_peak.py [--arch yi-6b]

Draws the arch's full weights on the card as the launcher does for
``--seed 0`` (bf16, one seeded generator on the device), saves them with the
port's checkpointer under build/ckpt_serve_peak/, frees them, and then runs
``launch.serve.main`` in flow mode (NFE 8, batch 4, seq 1024, one request,
no distillation) twice in this process: on its own seed-0 draw, and with
``--ckpt`` on the saved file. For each run: the peak device memory
(``torch.cuda.max_memory_allocated``, reset before it) and the wall time.
The served latents must be equal to the bit (the same weights and noise),
and the ``--ckpt`` run's peak no higher than the other's plus 1 GiB: the
restore builds the weights once, into a template with no storage. Prints
the card's name and power limit first; removes the file at the end. Needs
one card.
"""
from __future__ import annotations

import argparse
import gc
import shutil
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b")
    args = ap.parse_args(argv)

    from repro_torch.checkpoint import checkpointer
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.optim.adam import tree_leaves

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True, capture_output=True,
                         text=True).stdout.strip())
    dev = torch.device("cuda")
    cfg = get_config(args.arch)
    folder = ROOT / "build" / "ckpt_serve_peak"
    path = str(folder / "step_0.msgpack")
    t0 = time.perf_counter()
    params = M.init_params(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    weights = sum(p.numel() * p.element_size() for p in tree_leaves(params))
    checkpointer.save(path, params)
    print(f"{args.arch}: {weights / 2**30:.3f} GiB of weights saved in "
          f"{time.perf_counter() - t0:.1f} s ({Path(path).stat().st_size / 1e9:.3f} GB file)")
    del params

    flags = ["--arch", args.arch, "--mode", "flow", "--full", "--nfe", "8", "--batch", "4",
             "--seq", "1024", "--requests", "1", "--bns-iters", "0"]
    runs = {}
    for name, extra in (("seed 0", []), ("--ckpt", ["--ckpt", path])):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        served = serve.main(flags + extra)
        wall = time.perf_counter() - t0
        runs[name] = (served[0].latents.clone(), torch.cuda.max_memory_allocated(dev), wall)
        del served
    shutil.rmtree(folder, ignore_errors=True)
    (seed_lat, seed_peak, seed_wall), (ckpt_lat, ckpt_peak, ckpt_wall) = runs.values()
    equal = bool(torch.equal(seed_lat, ckpt_lat))
    print(f"serve {args.arch} flow, one request: seed-0 weights peak {seed_peak / 2**30:.3f} "
          f"GiB in {seed_wall:.1f} s; --ckpt peak {ckpt_peak / 2**30:.3f} GiB in "
          f"{ckpt_wall:.1f} s (weights {weights / 2**30:.3f} GiB); latents equal {equal}")
    ok = equal and ckpt_peak <= seed_peak + 2**30
    print("ckpt_serve_peak: " + ("ok" if ok else "FAILED"))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
