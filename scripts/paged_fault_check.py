#!/usr/bin/env python3
"""Show that chip_smoke.py's paged-attention limits pass the kernel and fail
planted faults.

    python3 scripts/paged_fault_check.py      # from the repository root, one card

Builds ``csrc/paged_attention.cu`` as it is and a few copies of it, each with
one fault planted as a text replacement, into ``build/repro_torch/faults``:
the merge drops the last split, the merge skips the rescale by
exp(m_split - m), the kernel reads one position past the row's length, and
a split's end moves by one position. Every build runs at chip_smoke.py's
phase-3 paged shapes (the decode cell, the long rows with bf16 and f32
pages, the small sweep and the poisoned tails, the lengths drawn the same
way) against the plain version, and prints per shape the largest absolute
error and its largest ratio to the limit (f32 output: 4x TOL; bf16 output:
one bf16 ulp, ``PAGED_BF16``). A fault must fail the limit at some shape;
the sound kernel must pass at every shape. Exits non-zero otherwise.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from chip_smoke import paged_errors, paged_inputs, poison_tails  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import paged_attention as pa_mod  # noqa: E402
from repro_torch.kernels.flash_attention.ref import paged_attention_ref  # noqa: E402

MERGE = "const bool in = sp < live;"
RESCALE = "const float c = __expf(m[j] - mn);"
LENGTH = "const int n = length < 0 ? 0 : min(length, cap);"
BOUNDARY = "const int end = min(start + span, n);"
# name -> (text in csrc/paged_attention.cu, its faulty replacement)
FAULTS = {
    "merge drops the last split": (MERGE, MERGE.replace("sp < live", "sp < live - 1")),
    "merge skips the rescale": (RESCALE, "const float c = 1.f;"),
    "reads one position past the length": (LENGTH, LENGTH.replace("min(length, cap)",
                                                                  "min(length + 1, cap)")),
    "split boundary moved by one": (BOUNDARY, BOUNDARY.replace("start + span",
                                                               "start + span + 1")),
}
BF16, F32 = torch.bfloat16, torch.float32
DECODE = [129, 1, 17, 64, 100, 33, 128, 16]
LONG = [4096, 3001, 2048, 1, 777, 4095, 1500, 3333]
SHAPES = [  # (B, KV, G, hd, ps, nb, q dtype, page dtype, lengths, poison): chip_smoke.py
    (8, 4, 8, 128, 16, 16, BF16, F32, DECODE, False),
    (8, 4, 8, 128, 16, 256, BF16, BF16, LONG, False),
    (8, 4, 8, 128, 16, 256, BF16, F32, LONG, False),
    (2, 2, 2, 64, 8, 4, F32, F32, [2, 12], False),
    (3, 1, 4, 32, 16, 2, F32, F32, [1, 19, 32], False),
    (1, 4, 1, 64, 8, 3, F32, F32, [9], False),
    (4, 4, 8, 128, 16, 16, BF16, F32, [5, 37, 1, 200], True),
]


def build_faults() -> dict[str, ctypes.CDLL]:
    src = (build.CSRC / "paged_attention.cu").read_text()
    out_dir = build.BUILD_DIR / "faults"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, (old, new)) in enumerate(FAULTS.items()):
        if src.count(old) != 1:
            raise SystemExit(f"fault {name!r}: its target occurs {src.count(old)} times")
        cu = out_dir / f"paged_attention_fault{i}.cu"
        cu.write_text(src.replace(old, new))
        so = cu.with_suffix(".so")
        procs[name] = (so, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for fault {name!r}:\n{log}")
        lib = ctypes.CDLL(str(so))
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("paged_fault_check: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip())
    build.build_all(("paged_attention",))
    variants = {"sound": pa_mod.bind(build.load("paged_attention"))}
    variants.update({name: pa_mod.bind(lib) for name, lib in build_faults().items()})
    print("limit: f32 output |err| <= 4 TOL (1 + |ref|); bf16 output |err| <= "
          "2^-7 |ref| + 1e-6")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    caught = {name: False for name in FAULTS}
    sound_ok = True
    for B, KV, G, hd, ps, nb, q_dtype, page_dtype, lengths, poison in SHAPES:
        q, k, v, table, lens = paged_inputs(g, dev, B, KV, G, hd, ps, nb, q_dtype,
                                            page_dtype, lengths)
        if poison:
            poison_tails(k, v, table, lengths)
        ref = paged_attention_ref(q, k, v, table, lens)
        shape = (f"B={B} KV={KV} G={G} hd={hd} ps={ps} nb={nb} q {str(q_dtype)[6:]} "
                 f"pages {str(page_dtype)[6:]} lengths<={max(lengths)}"
                 f"{' poisoned' if poison else ''}")
        for name, entry in variants.items():
            pa_mod._FN[:] = [entry]       # the wrapper launches this build
            try:
                out = pa_mod.paged_attention(q, k, v, table, lens)
                torch.cuda.synchronize()
            finally:
                pa_mod._FN[:] = [variants["sound"]]
                for state in pa_mod._DEVICES.values():   # a fault may leave arrivals
                    state.counters.zero_()
            e = paged_errors(out, ref)
            passed = e["ratio"] <= 1
            print(f"{shape} [{name}]: max abs {e['max_abs']:.4e}, ratio {e['ratio']:.4f}: "
                  f"{'pass' if passed else 'FAIL'}")
            if name == "sound":
                sound_ok &= passed
            else:
                caught[name] |= not passed
    print(f"sound kernel passes every shape: {sound_ok}; faults caught: {caught}")
    return 0 if sound_ok and all(caught.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
