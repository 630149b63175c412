#!/usr/bin/env python3
"""Where one decode step's time goes on the card: a ``torch.profiler`` trace
of the decode cell's engine call.

    PYTHONPATH=src python3 scripts/decode_profile.py [--steps 5] [--layers 32]

Builds yi-6b at full width (bf16 weights, random from a seeded generator on
the card) behind a paged ``DecodeEngine`` with the paged-attention kernel, as
``chip_smoke.py``'s decode phase serves it: 8 slots of 256 positions in
pages of 16, f32 slot state. Every slot is filled to 64 positions by
``prefill_slots``, then ``--steps`` calls of ``step_slots`` over all 8 rows
run under the profiler after two unprofiled warm-up calls. Prints the card's
name and power limit, the wall time of each profiled call (host clock; the
call returns after the card has finished), the device's busy share of that
wall time (the union of the kernels' intervals), and the operators that take
the most device and host time. Needs one card.
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
    for _ in range(2):                                   # warm-up
        feed, state = engine.step_slots(feed, state, active)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    walls = []
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(args.steps):
            t0 = time.perf_counter()
            feed, state = engine.step_slots(feed, state, active)
            walls.append((time.perf_counter() - t0) * 1e3)
    events = prof.events()
    busy = busy_ms(events)
    print(f"yi-6b, {args.layers} layers, 8 slots at ~64 positions, paged kernel: step ms "
          f"{[round(w, 3) for w in walls]}; device busy {busy / args.steps:.3f} ms a step "
          f"({100 * busy / sum(walls):.1f}% of the wall time)")
    table_rows = prof.key_averages().table(sort_by="self_device_time_total", row_limit=15,
                                           max_name_column_width=60)
    print(table_rows)
    print(prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=12,
                                    max_name_column_width=60))
    return 0


if __name__ == "__main__":
    sys.exit(main())
