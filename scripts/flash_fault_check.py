#!/usr/bin/env python3
"""Show that the bf16 flash-attention limit passes the kernel and fails
planted faults.

    python3 scripts/flash_fault_check.py      # from the repository root, one card

Builds ``csrc/flash_attention.cu`` as it is and a few copies of it, each with
one fault planted in the tensor-core (bf16) kernel, into
``build/repro_torch/faults``. Every build runs at the bf16 shapes of
``chip_smoke.py`` and ``tests/test_torch_cuda.py`` against the plain version,
and prints per shape: the largest absolute error, the largest elementwise
ratio |err| / (atol + rtol |ref|) under the limit and under the earlier
``atol = rtol = 0.08``, and the largest relative L2 error of one output row
(over the head dim). A fault must fail the limit at some shape; the sound
kernel must pass at every shape. Exits non-zero otherwise.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from chip_smoke import FLASH_BF16, flash_bf16_errors  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402

LOOP = "for (int k0 = 0; k0 < k_end; k0 += kMmaBK) {"
KEEP = "const bool keep = col < Lk && (!CAUSAL || col <= row);"
# name -> (text in the tensor-core kernel, its faulty replacement)
FAULTS = {
    "tail tile dropped": (LOOP, "for (int k0 = 0; k0 + kMmaBK <= k_end; k0 += kMmaBK) {"),
    "causal limit one tile short": (
        "const int k_end = CAUSAL ? min(Lk, q_last + 1) : Lk;\n\n  " + LOOP,
        "const int k_end = CAUSAL ? min(Lk, q_last + 1) - kMmaBK : Lk;\n\n  " + LOOP),
    "diagonal mask leaks one key": (KEEP, KEEP.replace("col <= row", "col <= row + 1")),
    "late rows leak one key": (KEEP, KEEP.replace("col <= row", "col <= row + (row >= Lq / 2)")),
}
SHAPES = [  # (B, H, KV, L, hd, causal)
    (4, 32, 4, 1024, 128, True),     # chip_smoke.py: main path
    (4, 32, 4, 1024, 128, False),
    (4, 32, 4, 1000, 128, True),     # ragged L
    (1, 4, 2, 256, 64, True),        # tests/test_torch_cuda.py
    (2, 8, 8, 128, 128, True),
    (1, 4, 1, 256, 64, True),
    (1, 2, 2, 128, 128, False),
    (2, 8, 2, 100, 80, True),
    (1, 4, 4, 1, 128, True),
    (1, 32, 4, 1000, 128, True),
    (1, 4, 2, 77, 80, False),
]


def build_faults() -> dict[str, ctypes.CDLL]:
    src = (build.CSRC / "flash_attention.cu").read_text()
    out_dir = build.BUILD_DIR / "faults"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, (old, new)) in enumerate(FAULTS.items()):
        if src.count(old) != 1:
            raise SystemExit(f"fault {name!r}: its target occurs {src.count(old)} times")
        cu = out_dir / f"flash_attention_fault{i}.cu"
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
        print("flash_fault_check: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip())
    build.build_all(("flash_attention",))
    sound = build.load("flash_attention")
    variants = {"sound": sound, **build_faults()}
    print(f"limit: |err| <= {FLASH_BF16['atol']} + {FLASH_BF16['rtol']} |ref| elementwise, "
          f"and relative L2 of each row <= {FLASH_BF16['row_rel_l2']}")
    dev = torch.device("cuda")
    caught = {name: False for name in FAULTS}
    sound_ok = True
    for B, H, KV, L, hd, causal in SHAPES:
        rng = np.random.default_rng(B + H + L + hd)
        q, k, v = (torch.from_numpy(rng.standard_normal((B, n, L, hd)).astype(np.float32))
                   .to(dev, torch.bfloat16) for n in (H, KV, KV))
        ref = attention_ref(q, k, v, causal=causal)
        for name, lib in variants.items():
            build._LIBS["flash_attention"] = lib   # the wrapper launches this build
            try:
                out = flash_attention(q, k, v, causal=causal)
            finally:
                build._LIBS["flash_attention"] = sound
            e = flash_bf16_errors(out, ref)
            old = flash_bf16_errors(out, ref, atol=0.08, rtol=0.08)["ratio"]
            passed = e["ratio"] <= 1 and e["row_rel_l2"] <= FLASH_BF16["row_rel_l2"]
            print(f"B={B} H={H} KV={KV} L={L} hd={hd} {'causal' if causal else 'full'} "
                  f"[{name}]: max abs {e['max_abs']:.4e}, ratio {e['ratio']:.4f} "
                  f"(earlier limit {old:.4f}), row rel L2 {e['row_rel_l2']:.4e}: "
                  f"{'pass' if passed else 'FAIL'}")
            if name == "sound":
                sound_ok &= passed
            else:
                caught[name] |= not passed
    print(f"sound kernel passes every shape: {sound_ok}; "
          f"faults caught: {caught}")
    return 0 if sound_ok and all(caught.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
