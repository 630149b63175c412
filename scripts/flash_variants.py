#!/usr/bin/env python3
"""Time diagnostic variants of the bf16 flash-attention kernel beside SDPA.

    python3 scripts/flash_variants.py      # from the repository root, one card

Each variant is ``csrc/flash_attention.cu`` with one part taken out or
changed by text replacement (each target must occur exactly once), built
into ``build/repro_torch/variants``. Some variants compute wrong outputs on
purpose (no loads, no exponentials, no stores): they only show what that
part costs. All variants and SDPA are timed in this one process, in turns,
three rounds per shape, at the main path's shape, causal and full, so the
numbers compare on one card. Prints the card, then one line per round.
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

from chip_smoke import FLASH_BF16, flash_bf16_errors, time_ms  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402

KV_LOADS = """          mbar_expect_tx(full(s), P::kStageBytes);
          const uint32_t sK = k_tile(s), sV = sK + P::kTileBytes;
          for (int c = 0; c < P::kChunks; ++c) {
            tma_load(sK + c * P::kKVChunk, &tk, full(s), c * P::kCW, t * kWsBK, kvh, it.b);
            tma_load(sV + c * P::kKVChunk, &tv, full(s), c * P::kCW, t * kWsBK, kvh, it.b);
          }"""
Q_LOAD = """        mbar_expect_tx(q_full, P::kQBytes);
        for (int c = 0; c < P::kChunks; ++c)
          tma_load(sQ + c * P::kQChunk, &tq, q_full, c * P::kCW, it.q0, it.h, it.b);"""
STORE = """            *reinterpret_cast<uint32_t*>(ob + row * so.l + j * 8 + 2 * t4) =
                pack_bf16(acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);"""
EPILOGUE = """        if (row < Lq) {
          const float inv = 1.f / fmaxf(l[r], 1e-30f);
#pragma unroll
          for (int j = 0; j < HD / 8; ++j)
""" + STORE + """
        }"""
HINTS = """__device__ __forceinline__ uint64_t l2_policy(bool first) {
  uint64_t p;
  if (first) asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(p));
  else asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(p));
  return p;
}
__device__ __forceinline__ void tma_load_hint(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                              int c0, int c1, int c2, int c3, uint64_t pol) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
      " [%0], [%1, {%2, %3, %4, %5}], [%6], %7;\\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar),
      "l"(pol) : "memory");
}
__device__ __forceinline__ void st_hint(void* p, uint32_t v, uint64_t pol) {
  asm volatile("st.global.L2::cache_hint.b32 [%0], %1, %2;" ::"l"(p), "r"(v), "l"(pol)
               : "memory");
}
"""
TRANSPOSE = """__device__ __forceinline__ void quad_transpose(const uint32_t (&x)[4], uint32_t (&y)[4],
                                               int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int send = (t + k) & 3, src = (t - k) & 3;
    const uint32_t v = send == 0 ? x[0] : send == 1 ? x[1] : send == 2 ? x[2] : x[3];
    const uint32_t w = __shfl_sync(0xffffffffu, v, (lane & ~3) | src);
#pragma unroll
    for (int i = 0; i < 4; ++i) y[i] = src == i ? w : y[i];
  }
}
"""
DESC = "// wgmma shared-memory descriptor: start address,"
FIRST_S = """        named_sync(kTurnBarrier + cw);
        wgmma_fence();
        issue_s(sc, tiles);
        named_arrive(kTurnBarrier + 1 - cw);"""

# name -> [(text, replacement)]
VARIANTS = {
    "kernel": [],
    "no K/V loads": [(KV_LOADS, "if (tiles < P::kStages) {\n" + KV_LOADS
                      + "\n} else mbar_arrive(full(s));")],
    "no exponentials": [("sc[i] = fast_exp2(fmaf(sc[i], scale_log2, -mc[(i >> 1) & 1]));",
                         "sc[i] = fmaf(sc[i], scale_log2, -mc[(i >> 1) & 1]);")],
    "no turn-taking": [('asm volatile("bar.sync %0, 256;\\n" ::"r"(id) : "memory");', ""),
                       ('asm volatile("bar.arrive %0, 256;\\n" ::"r"(id) : "memory");', "")],
    "registers 24/240": [("setmaxnreg.dec.sync.aligned.u32 40;", "setmaxnreg.dec.sync.aligned.u32 24;"),
                         ("setmaxnreg.inc.sync.aligned.u32 232;",
                          "setmaxnreg.inc.sync.aligned.u32 240;")],
    "2 stages": [("static constexpr int kStages = kFit < 4 ? kFit : 4;",
                  "static constexpr int kStages = 2;"),
                 ('static_assert(kStages >= 3, "a tile\'s V is read while the next two tiles load");',
                  "")],
    "Q loaded once": [(Q_LOAD, "if (round == 0) {\n" + Q_LOAD + "\n} else mbar_arrive(q_full);")],
    "no output stores": [(STORE, "            if (inv == 12345.f) " + STORE.strip())],
    "16-byte stores": [(DESC, TRANSPOSE + DESC), (EPILOGUE, """        const float inv = 1.f / fmaxf(l[r], 1e-30f);
#pragma unroll
        for (int j0 = 0; j0 < HD / 8; j0 += 4) {
          uint32_t x[4], y[4] = {0u, 0u, 0u, 0u};
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            const int j = j0 + s < HD / 8 ? j0 + s : j0;
            x[s] = pack_bf16(acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
          }
          quad_transpose(x, y, lane);
          if (row < Lq && j0 + t4 < HD / 8)
            *reinterpret_cast<uint4*>(ob + row * so.l + (j0 + t4) * 8) =
                make_uint4(y[0], y[1], y[2], y[3]);
        }""")],
    "L2 hints": [(DESC, HINTS + DESC),
                 (STORE, """            st_hint(ob + row * so.l + j * 8 + 2 * t4,
                    pack_bf16(acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv),
                    l2_policy(true));"""),
                 ("tma_load(sQ + c * P::kQChunk, &tq, q_full, c * P::kCW, it.q0, it.h, it.b);",
                  "tma_load_hint(sQ + c * P::kQChunk, &tq, q_full, c * P::kCW, it.q0, it.h, it.b,"
                  " l2_policy(true));"),
                 ("tma_load(sK + c * P::kKVChunk, &tk, full(s), c * P::kCW, t * kWsBK, kvh, it.b);",
                  "tma_load_hint(sK + c * P::kKVChunk, &tk, full(s), c * P::kCW, t * kWsBK, kvh,"
                  " it.b, l2_policy(false));"),
                 ("tma_load(sV + c * P::kKVChunk, &tv, full(s), c * P::kCW, t * kWsBK, kvh, it.b);",
                  "tma_load_hint(sV + c * P::kKVChunk, &tv, full(s), c * P::kCW, t * kWsBK, kvh,"
                  " it.b, l2_policy(false));")],
    "no fence before an item's first S": [(FIRST_S, FIRST_S.replace("        wgmma_fence();\n", ""))],
}
# variants that give wrong outputs by design
DIAGNOSTIC = {"no K/V loads", "no exponentials", "Q loaded once", "no output stores"}


def sources() -> dict[str, str]:
    src = (build.CSRC / "flash_attention.cu").read_text()
    out = {}
    for name, reps in VARIANTS.items():
        text = src
        for old, new in reps:
            if text.count(old) != 1:
                raise SystemExit(f"variant {name!r}: its target occurs {text.count(old)} times")
            text = text.replace(old, new)
        out[name] = text
    return out


def build_variants() -> dict[str, ctypes.CDLL]:
    out_dir = build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, text) in enumerate(sources().items()):
        cu = out_dir / f"flash_attention_variant{i}.cu"
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
        if "C7520" in log:
            print(f"{name}: ptxas serialises its wgmma (C7520)")
        lib = ctypes.CDLL(str(so))
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_variants: no CUDA device", file=sys.stderr)
        return 1
    import torch.nn.functional as F

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip())
    build.build_all(("flash_attention",))
    sound = build.load("flash_attention")
    libs = build_variants()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    ok = True
    for causal in (True, False):
        B, H, KV, L, hd = 4, 32, 4, 1024, 128
        q, k, v = (torch.randn((B, L, n, hd), generator=g, device=dev).bfloat16().transpose(1, 2)
                   for n in (H, KV, KV))
        ref = attention_ref(q, k, v, causal=causal)
        for rnd in range(3):
            res = {"SDPA": time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=True))}
            for name, lib in libs.items():
                build._LIBS["flash_attention"] = lib   # the wrapper launches this build
                try:
                    out = flash_attention(q, k, v, causal=causal)
                    res[name] = time_ms(lambda: flash_attention(q, k, v, causal=causal))
                finally:
                    build._LIBS["flash_attention"] = sound
                e = flash_bf16_errors(out, ref)
                inside = e["ratio"] <= 1 and e["row_rel_l2"] <= FLASH_BF16["row_rel_l2"]
                if name not in DIAGNOSTIC and not inside:
                    print(f"{name}: outside the bf16 limit: {e}")
                    ok = False
            print(f"B={B} H={H} KV={KV} L={L} hd={hd} {'causal' if causal else 'full'} "
                  f"round {rnd}: " + ", ".join(f"{n} {t:.4f} ms" for n, t in res.items()))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
