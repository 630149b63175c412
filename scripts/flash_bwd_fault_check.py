#!/usr/bin/env python3
"""Show that the flash backward's limits pass the kernel and fail planted faults.

    python3 scripts/flash_bwd_fault_check.py      # from the repository root, one card

Builds ``csrc/flash_attention_bwd.cu`` as it is and copies of it, each with one
fault planted by text replacement, into ``build/repro_torch/faults``. At the
shapes of ``chip_smoke.py`` phase 3c, every build's dq, dk and dv are held
against the plain version (``attention_bwd_ref``) on the same inputs, with o
and lse from the forward kernel: bf16 under ``chip_smoke.FLASH_BWD_BF16``
(elementwise ratio |err| / (atol + rtol |ref|) and row relative L2), f32 under
4 TOL. Prints per shape and build the largest ratio to each limit. A fault
must fail at some bf16 shape of each head dim (the tensor-core path, built
for hd 64, 80 and 128) and at some f32 shape (the CUDA-core path); the sound
kernel must pass at every shape. Exits non-zero otherwise.
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

from chip_smoke import FLASH_BWD_BF16, TOL, flash_bwd_errors, flash_bwd_passes  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention.flash_attention import (  # noqa: E402
    flash_attention,
    flash_attention_bwd,
)
from repro_torch.kernels.flash_attention.ref import attention_bwd_ref  # noqa: E402

SOURCE = "flash_attention_bwd"
# name -> [(text in csrc/flash_attention_bwd.cu, its faulty replacement)]: each
# fault is planted in both paths, the CUDA-core kernels (f32) and the TMA +
# wgmma kernels (bf16), so every shape below meets it.
FAULTS = {
    "D term dropped": [
        ("Sw[r * kTile + lane] = p * (dp[r] - Dr[r]);", "Sw[r * kTile + lane] = p * dp[r];"),
        ("Sw[r * kTile + lane] = p * (dp[r] - D_i);", "Sw[r * kTile + lane] = p * dp[r];"),
        ("sc[e] = p * (dp[e] - D_r[r]);", "sc[e] = p * dp[e];"),
        ("const float2 dd = *reinterpret_cast<const float2*>(col_D + 8 * j + 2 * t4);",
         "const float2 dd = make_float2(0.f, 0.f);")],
    "one head of the group missing from dK/dV": [
        ("for (int hg = 0; hg < G; ++hg) {", "for (int hg = 0; hg < G - (G > 1); ++hg) {"),
        ("const int n_items = G * n_q;", "const int n_items = (G - (G > 1)) * n_q;")],
    "causal limit one tile short": [
        ("const int q_begin = CAUSAL ? k0 : 0;", "const int q_begin = CAUSAL ? k0 + kTile : 0;"),
        ("const int first_q = CAUSAL ? k0 : 0;",
         "const int first_q = CAUSAL ? k0 + kKvQueries : 0;")],
    "last key tile dropped": [
        ("for (int k0 = 0; k0 < k_end; k0 += kTile) {",
         "for (int k0 = 0; k0 < k_end && (k0 == 0 || k0 + kTile < k_end); k0 += kTile) {"),
        ("const int n_tiles = (key_end + kDqKeys - 1) / kDqKeys;",
         "const int n_tiles = max(1, (key_end + kDqKeys - 1) / kDqKeys - 1);")],
    "scale missing on dK": [
        ("dkb[j * sdk.l + col0 + P::kLanesRow * c] = acc_dk[r][c] * scale;",
         "dkb[j * sdk.l + col0 + P::kLanesRow * c] = acc_dk[r][c];"),
        ("const float m = cw == 0 ? 1.f : scale;", "const float m = 1.f;")],
}
BF16, F32 = torch.bfloat16, torch.float32
SHAPES = [  # (B, H, KV, Lq, Lk, hd, dtype, causal): chip_smoke.py phase 3c
    (4, 32, 4, 1024, 1024, 128, BF16, True),
    (4, 32, 4, 1024, 1024, 128, F32, True),
    (4, 32, 4, 1024, 1024, 128, BF16, False),
    (4, 32, 4, 1000, 1000, 128, BF16, True),
    (4, 32, 4, 1000, 1000, 128, F32, False),
    (2, 8, 2, 77, 77, 128, F32, True),
    (1, 4, 4, 33, 33, 128, BF16, False),
    # the tensor-core path at whisper-medium's and zamba2-2.7b's head dims
    (2, 16, 4, 1000, 1000, 64, BF16, True),
    (2, 16, 16, 300, 450, 64, BF16, False),
    (2, 32, 8, 1000, 1000, 80, BF16, True),
    (1, 8, 2, 200, 77, 80, BF16, False),
]


def fault_sources() -> dict[str, str]:
    src = (build.CSRC / f"{SOURCE}.cu").read_text()
    out = {}
    for name, edits in FAULTS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"fault {name!r}: its target occurs {text.count(old)} times")
            text = text.replace(old, new)
        out[name] = text
    return out


def build_faults() -> dict[str, ctypes.CDLL]:
    out_dir = build.BUILD_DIR / "faults"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, text) in enumerate(fault_sources().items()):
        cu = out_dir / f"{SOURCE}_fault{i}.cu"
        cu.write_text(text)
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


def path_of(hd: int, dtype) -> str:
    """The kernel a shape reaches: bf16 the tensor cores at each head dim,
    f32 the CUDA cores."""
    return f"bf16 hd {hd}" if dtype == BF16 else "f32"


def judge(got, ref, dtype) -> tuple[bool, str]:
    """(passes, what it printed) for dq, dk, dv against the plain version."""
    ok, parts = True, []
    for what, x, r in zip(("dq", "dk", "dv"), got, ref):
        if dtype == BF16:
            e = flash_bwd_errors(x, r)
            passed = flash_bwd_passes(e)
            parts.append(f"{what} ratio {e['ratio']:.4g} row {e['row_rel_l2']:.3e}")
        else:
            lim = TOL[F32] * 4
            ratio = float(((x - r).abs() / (lim + lim * r.abs())).max())
            passed = ratio <= 1
            parts.append(f"{what} ratio {ratio:.4g}")
        ok &= passed
    return ok, ", ".join(parts)


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_bwd_fault_check: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip())
    build.build_all(("flash_attention", SOURCE))
    sound = build.load(SOURCE)
    variants = {"sound": sound, **build_faults()}
    print(f"limits: bf16 {FLASH_BWD_BF16}; f32 |err| <= 4 TOL (1 + |ref|), TOL "
          f"{TOL[F32]}")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(6)
    paths = sorted({path_of(hd, dtype) for *_, hd, dtype, _ in SHAPES})
    caught = {(name, path): False for name in FAULTS for path in paths}
    sound_ok = True
    for B, H, KV, Lq, Lk, hd, dtype, causal in SHAPES:
        q, do = (torch.randn((B, Lq, H, hd), generator=g, device=dev).to(dtype).transpose(1, 2)
                 for _ in "qo")
        k, v = (torch.randn((B, Lk, KV, hd), generator=g, device=dev).to(dtype).transpose(1, 2)
                for _ in "kv")
        o, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
        ref = attention_bwd_ref(q, k, v, o, lse, do, causal=causal)
        for name, lib in variants.items():
            build._LIBS[SOURCE] = lib   # the wrapper launches this build
            try:
                got = flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
                torch.cuda.synchronize()
            finally:
                build._LIBS[SOURCE] = sound
            passed, text = judge(got, ref, dtype)
            print(f"B={B} H={H} KV={KV} Lq={Lq} Lk={Lk} hd={hd} {str(dtype)[6:]} "
                  f"{'causal' if causal else 'full'} [{name}]: {text}: "
                  f"{'pass' if passed else 'FAIL'}")
            if name == "sound":
                sound_ok &= passed
            else:
                caught[name, path_of(hd, dtype)] |= not passed
    print(f"sound kernel passes every shape: {sound_ok}; faults caught: {caught}")
    return 0 if sound_ok and all(caught.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
