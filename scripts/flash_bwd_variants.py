#!/usr/bin/env python3
"""Time the bf16 flash backward beside copies with parts taken out, and
beside another checkout's backward, in one process.

    python3 scripts/flash_bwd_variants.py                          # one card
    python3 scripts/flash_bwd_variants.py --hd 80                  # zamba2-2.7b's shape
    git archive <commit> | tar -x -C build/other                   # e.g. the parent
    python3 scripts/flash_bwd_variants.py --against build/other

Each variant is ``csrc/flash_attention_bwd.cu`` with one part changed by text
replacement (each target must occur as often as stated), built into
``build/repro_torch/variants``:

- no dQ store: the dq pass computes dQ but does not write it;
- one part: P and dS enter their products as one bf16 part (the low part's
  products are left out); its outputs are held to the bf16 limit and the
  ratios printed, since it changes the precision;
- no D: the dq pass reads no O rows for D (D = 0);
- no loads: each producer fills the ring once and then only signals it (the
  math alone, on stale tiles);
- no turn-taking: the dq pass's consumer warpgroups issue their products
  without waiting for their turns;
- registers 40/232 and 56/224: other producer/consumer register splits.

Diagnostic variants (no dQ store, no D, no loads) compute wrong outputs on purpose
and are not checked. At the flow cell's shape (B 4, H 32, KV 4, L 1024, hd
128, bf16), causal and full, and the ragged L 1000 (``--hd 128``, the
default); with ``--hd 80`` zamba2-2.7b's (B 4, 32 / 32 heads, L 1024, causal);
with ``--hd 64`` whisper-medium's (B 4, 16 / 16 heads, L 1024 causal, and its
cross-attention's Lq 1024 / Lk 1500 full), every variant is timed in
two rounds (the second in reverse order): the host-inclusive ms a call (CUDA
events, 20 calls after a warm-up) and the device ms of each pass (dq, dk/dv;
torch.profiler, 20 calls). With ``--against``, the other checkout's
wrapper (bound to its own build) is timed in the same turns. Prints the card's
name and power limit first, and ptxas' spill report of each build.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from chip_smoke import (  # noqa: E402
    BWD_PASSES,
    device_ms_by_kernel,
    flash_bwd_errors,
    flash_bwd_passes,
    time_ms,
)
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention as fa_mod  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_bwd_ref  # noqa: E402

SOURCE = "flash_attention_bwd"
DQ_STORE = """      if (row < Lq) *reinterpret_cast<uint4*>(dqb + row * sdq.l + unit * 8) = v;"""
LOW_PART = """#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs_mn<HD>(acc, lo[kk], mnmajor_desc<HD>(b, 64, kk));"""
DQ_LOADS = """        mbar_expect_tx(full(s), P::kStageBytes);
        const uint32_t sK = k_tile(s), sV = sK + P::kTileBytes;
        const int key0 = t * kDqKeys;
        for (int c = 0; c < P::kChunks; ++c) {
          tma_load(sK + c * P::chunk_bytes(kDqKeys), &tk, full(s), c * P::kCW, key0, kvh, b);
          tma_load(sV + c * P::chunk_bytes(kDqKeys), &tv, full(s), c * P::kCW, key0, kvh, b);
        }"""
KV_LOADS = """        mbar_expect_tx(full(s), P::kStageBytes + P::kRowsBytes);
        const uint32_t sQ = q_tile(s), sdO = sQ + P::kTileBytes;
        for (int c = 0; c < P::kChunks; ++c) {
          tma_load(sQ + c * P::chunk_bytes(kKvQueries), &tq, full(s), c * P::kCW, q0, h, b);
          tma_load(sdO + c * P::chunk_bytes(kKvQueries), &tdo, full(s), c * P::kCW, q0, h, b);
        }
        const float* rb = rows + ((long long)b * H + h) * 2 * Lpad + q0;
        const uint32_t sRows = sK + P::kRowsOffset + s * P::kRowsBytes;
        bulk_load(sRows, rb, P::kRowsBytes / 2, full(s));
        bulk_load(sRows + P::kRowsBytes / 2, rb + Lpad, P::kRowsBytes / 2, full(s));"""


def _once_then_signal(text: str) -> str:
    return "if (t < P::kStages) {\n" + text + "\n} else mbar_arrive(full(s));"


def _registers(dec: int, inc: int) -> list:
    return [("setmaxnreg.dec.sync.aligned.u32 24;", f"setmaxnreg.dec.sync.aligned.u32 {dec};", 2),
            ("setmaxnreg.inc.sync.aligned.u32 240;", f"setmaxnreg.inc.sync.aligned.u32 {inc};", 2)]


# name -> [(text, replacement, occurrences)]
VARIANTS = {
    "kernel": [],
    "no dQ store": [(DQ_STORE, DQ_STORE.replace("row < Lq", "row < Lq && scale == 12345.f"), 1)],
    "one part": [(LOW_PART, "", 1)],
    "no loads": [(DQ_LOADS, _once_then_signal(DQ_LOADS), 1),
                 (KV_LOADS, _once_then_signal(KV_LOADS), 1)],
    "no D": [("        x[r] = __ldg(reinterpret_cast<const uint2*>(ob + min(warp_row + r, Lq - 1) * so.l));",
              "        x[r] = make_uint2(0u, 0u);", 1)],
    "no turn-taking": [("  __device__ __forceinline__ void take() { named_sync(kTurnBarrier + cw); }",
                        "  __device__ __forceinline__ void take() {}", 1),
                       ("  __device__ __forceinline__ void hand_over() { named_arrive(kTurnBarrier + 1 - cw); }",
                        "  __device__ __forceinline__ void hand_over() {}", 1)],
    "registers 40/232": _registers(40, 232),
    "registers 56/224": _registers(56, 224),
}
DIAGNOSTIC = {"no dQ store", "no loads", "no D"}
SHAPES = {  # hd -> [(B, H, KV, Lq, Lk, causal)]
    128: [(4, 32, 4, 1024, 1024, True), (4, 32, 4, 1024, 1024, False),
          (4, 32, 4, 1000, 1000, True)],
    80: [(4, 32, 32, 1024, 1024, True)],
    64: [(4, 16, 16, 1024, 1024, True), (4, 16, 16, 1024, 1500, False)],
}


def sources() -> dict[str, str]:
    src = (build.CSRC / f"{SOURCE}.cu").read_text()
    out = {}
    for name, reps in VARIANTS.items():
        text = src
        for old, new, n in reps:
            if text.count(old) != n:
                raise SystemExit(f"variant {name!r}: its target occurs {text.count(old)} "
                                 f"times, not {n}")
            text = text.replace(old, new)
        out[name] = text
    return out


def spills(log: str) -> str:
    """ptxas' spill stores of each wgmma kernel, and any wgmma it serialises."""
    out = []
    for entry in log.split("Compiling entry function")[1:]:
        m = re.match(r" '\S*flash_bwd_(dq|dkdv)_wgmma_kernelILi(\d+)ELb(\d)E", entry)
        if m:
            n = re.search(r"(\d+) bytes spill stores", entry)
            out.append(f"{m[1]} hd {m[2]}{'' if m[3] == '1' else ' full'} "
                       f"{n[1] if n else '?'} B")
    serial = sorted(set(re.findall(r"\((C75\d\d)\) Potential Performance Loss: wgmma", log)))
    return ", ".join(out) + (f"; ptxas serialises wgmma ({', '.join(serial)})" if serial else "")


def build_variants() -> dict[str, ctypes.CDLL]:
    out_dir = build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, text) in enumerate(sources().items()):
        cu = out_dir / f"{SOURCE}_variant{i}.cu"
        cu.write_text(text)
        so = cu.with_suffix(".so")
        procs[name] = (so, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for variant {name!r}:\n{log}")
        print(f"[{name}] ptxas spill stores: {spills(log)}")
        lib = ctypes.CDLL(str(so))
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def load_other(root: Path):
    """The other checkout's flash-attention wrapper, bound to its own build."""
    def module(name: str, path: Path):
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    kernels = root / "src" / "repro_torch" / "kernels"
    other_build = module("other_build", kernels / "build.py")
    wrapper = module("other_flash_attention", kernels / "flash_attention" / "flash_attention.py")
    wrapper.build = other_build          # its launches load its own library
    other_build.build_all((SOURCE,))
    return wrapper


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--against", type=Path, help="root of another checkout of this repository")
    ap.add_argument("--hd", type=int, default=128, choices=sorted(SHAPES),
                    help="head dim of the shapes timed")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_bwd_variants: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip())
    build.build_all(("flash_attention", SOURCE))
    sound = build.load(SOURCE)
    libs = build_variants()
    runs = {name: (lib, fa_mod.flash_attention_bwd) for name, lib in libs.items()}
    if args.against:
        runs["other checkout"] = (sound, load_other(args.against.resolve()).flash_attention_bwd)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(6)
    ok = True
    hd = args.hd
    for B, H, KV, Lq, Lk, causal in SHAPES[hd]:
        q, do = (torch.randn((B, Lq, H, hd), generator=g, device=dev).bfloat16().transpose(1, 2)
                 for _ in "qo")
        k, v = (torch.randn((B, Lk, KV, hd), generator=g, device=dev).bfloat16().transpose(1, 2)
                for _ in "kv")
        o, lse = fa_mod.flash_attention(q, k, v, causal=causal, return_lse=True)
        ref = attention_bwd_ref(q, k, v, o, lse, do, causal=causal)
        shape = (f"B={B} H={H} KV={KV} Lq={Lq} Lk={Lk} hd={hd} bf16 "
                 f"{'causal' if causal else 'full'}")
        pairs = sum(min(i + 1, Lk) for i in range(Lq)) if causal else Lq * Lk
        executed = 20 * hd * pairs * B * H
        for rnd, order in enumerate((list(runs), list(runs)[::-1])):
            for name in order:
                lib, fn = runs[name]
                build._LIBS[SOURCE] = lib   # this checkout's wrapper launches this build
                try:
                    call = lambda: fn(q, k, v, o, lse, do, causal=causal)  # noqa: E731
                    got = call()
                    ms = time_ms(call, iters=20)
                    per = device_ms_by_kernel(call, BWD_PASSES if name != "other checkout" else
                                              ("flash_bwd",))
                finally:
                    build._LIBS[SOURCE] = sound
                text = ", ".join(f"{k} {'-' if t is None else f'{t:.4f}'}" for k, t in per.items())
                line = (f"{shape} round {rnd} [{name}]: {ms:.4f} ms "
                        f"({executed / ms / 1e9:.1f} TFLOP/s at 20 hd a pair); device ms {text}")
                if name not in DIAGNOSTIC and rnd == 0:
                    es = [flash_bwd_errors(x, r) for x, r in zip(got, ref)]
                    inside = all(flash_bwd_passes(e) for e in es)
                    line += "; limit ratio " + ", ".join(
                        f"{w} {e['ratio']:.4f} row {e['row_rel_l2']:.2e}"
                        for w, e in zip(("dq", "dk", "dv"), es))
                    line += "" if inside else " OUTSIDE the bf16 limit"
                    ok &= inside or name == "one part"
                print(line, flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
