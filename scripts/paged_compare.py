#!/usr/bin/env python3
"""Time this checkout's paged-attention kernel against another checkout's,
in turns, in one process.

    git archive <commit> | tar -x -C build/other     # e.g. the parent commit
    python3 scripts/paged_compare.py --against build/other    # one card

Loads the other checkout's ``kernels/build.py`` and paged-attention wrapper
beside this one's (each builds its own ``csrc/paged_attention.cu`` into its
own ``build/repro_torch``), and at chip_smoke.py's phase-3 paged shapes (the
decode cell, and the long rows with bf16 and f32 pages; inputs drawn the same
way) times both wrappers in the order other, this, this, other: the
host-inclusive ms a call (CUDA events over 300 back-to-back calls after a
warm-up) and the kernel's device ms a call (torch.profiler). Prints the
card's name and power limit, each time, and the largest difference between
the two outputs, which must stay within chip_smoke.py's paged limit.
"""
from __future__ import annotations

import argparse
import importlib.util
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from chip_smoke import LONG_LENGTHS, device_ms, paged_errors, paged_inputs, time_ms  # noqa: E402
from repro_torch.kernels.flash_attention import paged_attention as this  # noqa: E402

SHAPES = [  # (name, nb, page dtype, lengths): B 8, KV 4, G 8, hd 128, ps 16, bf16 q
    ("decode cell", 16, torch.float32, [129, 1, 17, 64, 100, 33, 128, 16]),
    ("long rows, bf16 pages", 256, torch.bfloat16, LONG_LENGTHS),
    ("long rows, f32 pages", 256, torch.float32, LONG_LENGTHS),
]


def load_other(root: Path):
    """The other checkout's paged_attention wrapper, bound to its own build."""
    def module(name: str, path: Path):
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    kernels = root / "src" / "repro_torch" / "kernels"
    other_build = module("other_build", kernels / "build.py")
    wrapper = module("other_paged_attention", kernels / "flash_attention" / "paged_attention.py")
    wrapper.build = other_build          # its launches load its own library
    other_build.build_all(("paged_attention",))
    return wrapper


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--against", type=Path, required=True,
                    help="root of another checkout of this repository")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("paged_compare: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip())
    other = load_other(args.against.resolve())
    wrappers = {"other": other.paged_attention, "this": this.paged_attention}
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    ok = True
    for name, nb, page_dtype, lengths in SHAPES:
        q, k, v, table, lens = paged_inputs(g, dev, 8, 4, 8, 128, 16, nb, torch.bfloat16,
                                            page_dtype, lengths)
        outs = {who: fn(q, k, v, table, lens) for who, fn in wrappers.items()}
        e = paged_errors(outs["this"], outs["other"])
        ok &= e["ratio"] <= 1
        print(f"{name}: this vs other max abs {e['max_abs']:.3e}, limit ratio {e['ratio']:.4f}")
        for who in ("other", "this", "this", "other"):
            fn = wrappers[who]
            ms = time_ms(lambda: fn(q, k, v, table, lens), iters=300, warmup=20)
            dev_ms = device_ms(lambda: fn(q, k, v, table, lens), "paged_attention", iters=300)
            dms = "not measured" if dev_ms is None else f"{dev_ms:.4f} ms"
            print(f"  [{who}] host-inclusive {ms:.4f} ms, device {dms}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
