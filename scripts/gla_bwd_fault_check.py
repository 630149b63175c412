#!/usr/bin/env python3
"""Show that the gla_scan backward's limit passes the kernel and fails planted faults.

    python3 scripts/gla_bwd_fault_check.py      # from the repository root, one card

Builds ``csrc/gla_scan_bwd.cu`` as it is and copies of it, each with one fault
of the tensor-core kernel planted by text replacement, into
``build/repro_torch/faults``. At bf16 shapes (rwkv6-7b's and zamba2-2.7b's of
``chip_smoke.py`` phase 3c, and smaller ones with a ragged tail, s0 and
dS_final, strong decay and chunks of 16 and 32), every build's dq, dk, dv,
dld (and ds0) are held against the plain backward taken in f64 on the same
inputs (``ref.gla_chunked_bwd``) under ``chip_smoke.gla_bwd_limit``: relative
L2 of each gradient, ``GLA_BWD_TOL`` for a bf16 one, ``GLA_BWD_F32_OUT_TOL``
for one kept in f32 (dld, ds0). Prints per shape and build each gradient's
distance. A
fault must fail at some shape; the sound kernel must pass every shape. Exits
non-zero otherwise.
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

from chip_smoke import gla_bwd_limit  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.gla_scan.gla_scan import bwd_kernel_for, gla_scan_bwd  # noqa: E402
from repro_torch.kernels.gla_scan.ref import gla_chunked_bwd  # noqa: E402

SOURCE = "gla_scan_bwd"
# name -> (text in csrc/gla_scan_bwd.cu, its faulty replacement), all in the
# tensor-core kernel
FAULTS = {
    # the diagonal triangles (dq's and dk's) take the diagonal pair in the
    # exclusive mode and drop it in the inclusive one
    "diagonal mask off by one": ("if (INCL ? ss <= tt : ss < tt) {",
                                 "if (INCL ? ss < tt : ss <= tt) {"),
    # S0 and G enter dq's and dk's state terms as their bf16 high parts alone
    "a lo part dropped": ("      mma_bf16(acc[h2], a, bl0, bl1);\n", ""),
    # k-bar scaled about the row before the key sub-chunk's last, its output
    # factor still about the last row
    "a reference point moved by a row": (
        "const float* rho = cz + ((t | 15) + 1) * ldc + d;",
        "const float* rho = cz + (t | 15) * ldc + d;"),
    # dld forgets the later chunks' sums
    "dld's carry dropped": ("float off = run[par * DK + d];", "float off = 0.f;"),
}
BF16 = torch.bfloat16
SHAPES = [  # (B, L, H, dk, dv, chunk, form, decay, s0 and dS_final)
    (4, 1024, 64, 64, 64, 64, "rwkv6", "model", False),    # rwkv6-7b's (phase 3c)
    (4, 1024, 80, 64, 64, 64, "mamba2", "mamba2", False),  # zamba2-2.7b's (phase 3c)
    (2, 200, 4, 64, 64, 64, "inclusive", 30.0, True),      # strong decay, ragged
    (2, 300, 4, 64, 64, 32, "rwkv6", 0.5, True),           # chunk 32
    (2, 256, 8, 32, 32, 16, "rwkv6", "model", False),      # chunk 16
]


def relative_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(got.double() - want)
                 / torch.linalg.vector_norm(want).clamp_min(1e-30))


def fault_sources() -> dict[str, str]:
    src = (build.CSRC / f"{SOURCE}.cu").read_text()
    out = {}
    for name, (old, new) in FAULTS.items():
        if src.count(old) != 1:
            raise SystemExit(f"fault {name!r}: its target occurs {src.count(old)} times")
        out[name] = src.replace(old, new)
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


def inputs(g, dev, B, L, H, dk, dv, form, decay, state):
    """q, k, v, ld, s0, do, dS_final as phase 3c draws them: "rwkv6" the
    exclusive form with rwkv6's decay ("model": -exp(-6 + small noise)) or
    -|N(0, 1)| x decay; "mamba2" zamba2-2.7b's (inclusive, q and k one group
    over the heads, one decay a head, softplus(dt - 2) x -exp(A_log));
    "inclusive" per-channel -|N(0, 1)| x decay."""
    if form == "mamba2":
        xbc = torch.randn((B, L, H * dv + 2 * dk), generator=g, device=dev).to(BF16)
        k = xbc[..., H * dv:H * dv + dk][:, :, None, :]
        q = xbc[..., H * dv + dk:][:, :, None, :]
        noise = torch.randn((B, L, H, 1), generator=g, device=dev)
        a_log = 0.5 * torch.randn((H, 1), generator=g, device=dev)
        ld = torch.nn.functional.softplus(noise - 2.0) * -torch.exp(a_log)
    else:
        q, k = (torch.randn((B, L, H, dk), generator=g, device=dev).to(BF16) for _ in "qk")
        noise = torch.randn((B, L, H, dk), generator=g, device=dev)
        ld = -torch.exp(-6.0 + 0.1 * noise) if decay == "model" else -noise.abs() * decay
    v, do = (torch.randn((B, L, H, dv), generator=g, device=dev).to(BF16) for _ in "vo")
    s0, dS = ((torch.randn((B, H, dk, dv), generator=g, device=dev) for _ in "sd")
              if state else (None, None))
    return q, k, v, ld, s0, do, dS


def main() -> int:
    if not torch.cuda.is_available():
        print("gla_bwd_fault_check: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip())
    build.build_all((SOURCE,))
    sound = build.load(SOURCE)
    variants = {"sound": sound, **build_faults()}
    print(f"limits (bf16 q, k, v): relative L2 of a bf16 gradient <= "
          f"{gla_bwd_limit(BF16, BF16)}, of one kept in f32 <= "
          f"{gla_bwd_limit(BF16, torch.float32)}")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(32)
    caught = dict.fromkeys(FAULTS, False)
    sound_ok = True
    for B, L, H, dk, dv, chunk, form, decay, state in SHAPES:
        args = inputs(g, dev, B, L, H, dk, dv, form, decay, state)
        inclusive = form != "rwkv6"
        f64 = lambda t: None if t is None else t.double()  # noqa: E731
        want = gla_chunked_bwd(*map(f64, args), inclusive=inclusive, chunk=chunk)
        shape = (f"B={B} L={L} H={H} dk={dk} dv={dv} chunk={chunk} {form} decay {decay}"
                 f"{' s0 and dS_final' if state else ''} "
                 f"[{bwd_kernel_for(BF16, L, dk, dv, chunk)}]")
        for name, lib in variants.items():
            build._LIBS[SOURCE] = lib   # the wrapper launches this build
            try:
                got = gla_scan_bwd(*args, inclusive=inclusive, chunk=chunk)
                torch.cuda.synchronize()
            finally:
                build._LIBS[SOURCE] = sound
            outs = [(what, x, w) for what, x, w in zip(("dq", "dk", "dv", "dld", "ds0"), got,
                                                       want) if w is not None]
            rels = {what: relative_l2(x, w) for what, x, w in outs}
            finite = all(bool(torch.isfinite(x.float()).all()) for _, x, _ in outs)
            passed = finite and all(rels[what] <= gla_bwd_limit(BF16, x.dtype)
                                    for what, x, _ in outs)
            text = ", ".join(f"{k} {v:.3e}" for k, v in rels.items())
            print(f"{shape} [{name}]: {text}: {'pass' if passed else 'FAIL'}", flush=True)
            if name == "sound":
                sound_ok &= passed
            else:
                caught[name] |= not passed
        del want
    print(f"sound kernel passes every shape: {sound_ok}; faults caught: {caught}")
    return 0 if sound_ok and all(caught.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
