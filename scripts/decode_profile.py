#!/usr/bin/env python3
"""Where one decode step's time goes on the card: ``torch.profiler`` traces
of the decode cell's engine call, eager and graphed.

    PYTHONPATH=src python3 scripts/decode_profile.py [--steps 5] [--layers 32]

Builds yi-6b at full width (bf16 weights, random from a seeded generator on
the card) behind a paged ``DecodeEngine`` with the paged-attention kernel, as
``chip_smoke.py``'s decode phase serves it: 8 slots of 256 positions in
pages of 16, f32 slot state. Every slot is filled to 64 positions by
``prefill_slots``, then ``--steps`` calls of ``step_slots`` over all 8 rows
run under the profiler after two unprofiled warm-up calls: once eagerly
(``programs.disabled()``) and once through the engine's CUDA graph (the
serving default; its warm-up calls capture it). For each, prints the wall
time of each profiled call (host clock; the call returns after the card has
finished), the device's busy time a step (the union of the kernels'
intervals) and its share of the wall time, the host's launches a step
(CUDA runtime launch calls: kernels, graphs, copies) and the operators that
take the most device and host time; then ``--steps`` unprofiled calls each
way, timed alone. Prints the card's name and power limit first. Needs one
card.
"""
from __future__ import annotations

import argparse
import dataclasses
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def busy_ms(events) -> float:
    """Milliseconds of the union of the device kernels' intervals."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    total, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total / 1e3


def host_launches(events, steps: int) -> dict:
    """CUDA runtime launch calls on the host a step, by kind."""
    kinds = {"kernel": ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC"),
             "graph": ("cudaGraphLaunch",), "copy": ("cudaMemcpyAsync", "cudaMemsetAsync")}
    out = dict.fromkeys(kinds, 0)
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CPU:
            for kind, names in kinds.items():
                if e.name.startswith(names):
                    out[kind] += 1
    return {k: v / steps for k, v in out.items()}


def profile_steps(engine, state, feed, active, steps: int, label: str) -> tuple:
    """Two warm-up calls, ``steps`` profiled calls and ``steps`` unprofiled
    ones; prints the figures of the module docstring."""
    for _ in range(2):                                   # warm-up (graphed: the capture)
        feed, state = engine.step_slots(feed, state, active)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    walls = []
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(steps):
            t0 = time.perf_counter()
            feed, state = engine.step_slots(feed, state, active)
            walls.append((time.perf_counter() - t0) * 1e3)
    alone = []
    for _ in range(steps):
        t0 = time.perf_counter()
        feed, state = engine.step_slots(feed, state, active)
        alone.append((time.perf_counter() - t0) * 1e3)
    events = prof.events()
    busy = busy_ms(events) / steps
    print(f"{label}: step ms {[round(w, 3) for w in walls]} profiled, "
          f"{[round(w, 3) for w in alone]} alone; device busy {busy:.3f} ms a step "
          f"({100 * busy * steps / sum(walls):.1f}% of the profiled wall time, "
          f"{100 * busy / sorted(alone)[len(alone) // 2]:.1f}% of the median step alone); "
          f"host launches a step {host_launches(events, steps)}")
    print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=15,
                                    max_name_column_width=60))
    print(prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=12,
                                    max_name_column_width=60))
    return feed, state


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--layers", type=int, default=32)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("decode_profile: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.serving import programs
    from repro_torch.serving.engine import DecodeEngine

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True, capture_output=True,
                         text=True).stdout.strip())
    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config("yi-6b"), n_layers=args.layers)
    params = M.init_params(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    engine = DecodeEngine(params=params, cfg=cfg, page_size=16, paged_kernel=True)
    slots, blocks = 8, 16
    state = engine.init_slot_state(slots, blocks * 16)
    table = (np.arange(slots * blocks) + 1).reshape(slots, blocks).astype(np.int32)
    state = engine.with_block_table(state, table)
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab, size=(slots, 64)).astype(np.int32)
    state = engine.prefill_slots(prompt, np.full(slots, 64, np.int32), state,
                                 np.ones(slots, bool))
    feed, active = prompt[:, -1], np.ones(slots, bool)
    what = f"yi-6b, {args.layers} layers, 8 slots at ~64 positions, paged kernel"
    with programs.disabled():
        feed, state = profile_steps(engine, state, feed, active, args.steps,
                                    f"{what}, eager")
    profile_steps(engine, state, feed, active, args.steps, f"{what}, graphed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
