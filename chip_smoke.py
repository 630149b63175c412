#!/usr/bin/env python3
"""Drive the port's main path on an NVIDIA card; hold every CUDA kernel
against its plain PyTorch version.

    python3 chip_smoke.py          # from the repository root, one card

Phases (any failure ends the run with a non-zero exit and no last line):

1. Device: the card's name and power limit, as nvidia-smi prints them.
2. Build: every source in src/repro_torch/kernels/csrc, one nvcc each, all
   started together, into build/repro_torch.
3. Kernels against their plain versions on the card, at the main path's
   shapes and a few others, with CUDA-event timing (100 launches after a
   warm-up) of the kernel, the plain version and the one PyTorch call that
   computes the same function (timed as a yardstick only; the port never
   calls it). TF32 is off.
4. Main path: ``repro_torch.launch.serve.main`` with yi-6b at full width
   (32 layers, bf16, random weights from a seeded generator on the card),
   NFE 8, batch 4, sequence 1024, 3 requests. Launch counts must be exact.
5. The whole path on the card (kernels) against the CPU (plain versions):
   yi-6b width cut to 2 layers, f32, euler NFE 4, relative L2 <= 1e-4.
6. One JSON line listing the kernels, then the last line.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}   # tests/test_kernels.py
# bf16 flash attention against its plain version. The kernel rounds the
# softmax weights P to bf16 before P·V and the output to bf16; the plain
# version keeps P in f32. Both limits must hold: elementwise
# |err| <= atol + rtol |ref|, and the relative L2 error of each output row
# (over the head dim) <= row_rel_l2, which catches a fault confined to late
# rows, where |o| is small. scripts/flash_fault_check.py shows the sound
# kernel inside both and planted faults outside.
FLASH_BF16 = {"atol": 4e-3, "rtol": 2e-2, "row_rel_l2": 1e-2}
HBM_BYTES_PER_S = 3.35e12                          # H100 SXM data sheet
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}  # CUDA-core f32, dense bf16
NFE, BATCH, SEQ, REQUESTS = 8, 4, 1024, 3


def time_ms(fn, iters: int = 100, warmup: int = 5) -> float:
    """Mean milliseconds per call of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float, dtype: torch.dtype) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_close(name: str, out: torch.Tensor, ref: torch.Tensor, atol: float,
                rtol: float) -> float:
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol,
                               msg=lambda m: f"{name}: kernel vs plain: {m}")
    return float((out.float() - ref.float()).abs().max())


def flash_bf16_errors(out: torch.Tensor, ref: torch.Tensor,
                      atol: float = FLASH_BF16["atol"],
                      rtol: float = FLASH_BF16["rtol"]) -> dict:
    """Largest |err|, largest |err| / (atol + rtol |ref|), and largest
    relative L2 error of one row over the last (head) dim."""
    ref = ref.float()
    err = (out.float() - ref).abs()
    row = (torch.linalg.vector_norm(err, dim=-1)
           / torch.linalg.vector_norm(ref, dim=-1).clamp_min(1e-30))
    return {"max_abs": float(err.max()),
            "ratio": float((err / (atol + rtol * ref.abs())).max()),
            "row_rel_l2": float(row.max())}


def check_flash_bf16(name: str, out: torch.Tensor, ref: torch.Tensor) -> float:
    e = flash_bf16_errors(out, ref)
    if not (e["ratio"] <= 1 and e["row_rel_l2"] <= FLASH_BF16["row_rel_l2"]):
        raise SystemExit(f"{name}: kernel vs plain outside the bf16 limit {FLASH_BF16}: {e}")
    return e["max_abs"]


def ns_update_cases(dev):
    from repro_torch.kernels.ns_update.ns_update import ns_update
    from repro_torch.kernels.ns_update.ref import ns_update_ref

    g = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for n, B, D, dtype in [(NFE, BATCH, SEQ * 64, torch.float32),   # main path
                           (20, 3, 1000, torch.float32),            # ragged D
                           (NFE, BATCH, SEQ * 64, torch.bfloat16)]:
        x0 = torch.randn((B, D), generator=g, device=dev).to(dtype)
        u = torch.randn((n, B, D), generator=g, device=dev).to(dtype)
        a = torch.randn((), generator=g, device=dev)
        w = torch.randn((n,), generator=g, device=dev)
        err = check_close(f"ns_update n={n} B={B} D={D} {dtype}",
                          ns_update(x0, u, a, w), ns_update_ref(x0, u, a, w),
                          atol=TOL[dtype] * n, rtol=TOL[dtype])
        beta, wl, xf, uf = a.item(), w.to(dtype), x0.view(-1), u.view(n, -1).t()
        size = x0.element_size()
        b_ms, b_by = bound((n + 2) * B * D * size, 2 * (n + 1) * B * D, dtype)
        rows.append(dict(
            shape=f"n={n} B={B} D={D} {str(dtype)[6:]}", max_abs_err=err,
            ms=time_ms(lambda: ns_update(x0, u, a, w)),
            plain_ms=time_ms(lambda: ns_update_ref(x0, u, a, w)),
            library_ms=time_ms(lambda: torch.addmv(xf, uf, wl, beta=beta)),
            bound_ms=b_ms, bound_by=b_by))
    return rows


def flash_cases(dev):
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref

    g = torch.Generator(device=dev).manual_seed(1)
    rows = []
    for B, H, KV, L, hd, dtype, causal in [
            (BATCH, 32, 4, SEQ, 128, torch.bfloat16, True),    # main path
            (BATCH, 32, 4, SEQ, 128, torch.bfloat16, False),
            (BATCH, 32, 4, 1000, 128, torch.bfloat16, True),   # ragged L
            (2, 8, 2, 512, 64, torch.float32, True),
            (2, 8, 2, 512, 80, torch.float32, True)]:
        # transposed views of the model's (B, L, heads, hd) layout, as on the main path
        q = torch.randn((B, L, H, hd), generator=g, device=dev).to(dtype).transpose(1, 2)
        k = torch.randn((B, L, KV, hd), generator=g, device=dev).to(dtype).transpose(1, 2)
        v = torch.randn((B, L, KV, hd), generator=g, device=dev).to(dtype).transpose(1, 2)
        name = f"flash_attention B={B} H={H} KV={KV} L={L} hd={hd} {dtype} causal={causal}"
        out, ref = flash_attention(q, k, v, causal=causal), attention_ref(q, k, v, causal=causal)
        if dtype == torch.bfloat16:
            err = check_flash_bf16(name, out, ref)
        else:
            err = check_close(name, out, ref, atol=TOL[dtype] * 4, rtol=TOL[dtype] * 4)
        pairs = L * (L + 1) // 2 if causal else L * L
        size = q.element_size()
        b_ms, b_by = bound((2 * B * H * L * hd + 2 * B * KV * L * hd) * size,
                           4 * hd * pairs * B * H, dtype)
        rows.append(dict(
            shape=f"B={B} H={H} KV={KV} L={L} hd={hd} {str(dtype)[6:]} "
                  f"{'causal' if causal else 'full'}", max_abs_err=err,
            ms=time_ms(lambda: flash_attention(q, k, v, causal=causal)),
            plain_ms=time_ms(lambda: attention_ref(q, k, v, causal=causal)),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=True)),
            bound_ms=b_ms, bound_by=b_by))
    return rows


def main_path(dev, counters):
    from repro_torch.launch import serve

    for c in counters.values():
        c.reset()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    served = serve.main(["--arch", "yi-6b", "--mode", "flow", "--full",
                         "--nfe", str(NFE), "--batch", str(BATCH), "--seq", str(SEQ),
                         "--requests", str(REQUESTS), "--bns-iters", "0"])
    wall = time.perf_counter() - t0
    launches = {name: c.launches for name, c in counters.items()}
    want = {"ns_update": NFE * REQUESTS, "flash_attention": 32 * NFE * REQUESTS}
    if launches != want:
        raise SystemExit(f"main path launch counts {launches}, expected {want}")
    if len(served) != REQUESTS:
        raise SystemExit(f"{len(served)} requests answered, expected {REQUESTS}")
    for s in served:
        if s.latents.shape != (BATCH, SEQ, 64) or not bool(torch.isfinite(s.latents).all()):
            raise SystemExit(f"bad latents: shape {tuple(s.latents.shape)}")
        if (s.tokens.shape != (BATCH, SEQ) or int(s.tokens.min()) < 0
                or int(s.tokens.max()) >= 64000):
            raise SystemExit(f"bad tokens: shape {tuple(s.tokens.shape)}")
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"main path: yi-6b full width, NFE {NFE}, batch {BATCH}, seq {SEQ}: "
          f"request ms {[round(s.ms, 3) for s in served]}, launches {launches}, "
          f"peak memory {peak / 2**30:.3f} GiB, main() wall {wall:.3f} s")
    return launches


def whole_path_against_cpu(dev, counters):
    from repro_torch.configs import get_config
    from repro_torch.core.schedulers import get_scheduler
    from repro_torch.data.synthetic import DataConfig, SyntheticTokens
    from repro_torch.models import model as M
    from repro_torch.models.transformer import params_to
    from repro_torch.serving.engine import FlowSampler
    from repro_torch.solvers.registry import build_ns

    cfg = dataclasses.replace(get_config("yi-6b"), n_layers=2, dtype="float32")
    params = M.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    batch = SyntheticTokens(cfg, DataConfig(batch_size=2, seq_len=128, seed=0),
                            device="cpu").batch(0)
    x0 = np.random.default_rng(0).standard_normal((2, 128, cfg.latent_dim)).astype(np.float32)
    kw = dict(cfg=cfg, sched=get_scheduler("fm_ot"), solver=build_ns("euler", 4))
    before = {name: c.launches for name, c in counters.items()}
    on_card = FlowSampler(params=params_to(params, dev), **kw).sample_from(batch, x0)
    torch.cuda.synchronize(dev)
    ran = {name: c.launches - before[name] for name, c in counters.items()}
    if ran != {"ns_update": 4, "flash_attention": 2 * 4}:
        raise SystemExit(f"card run launched {ran}")
    on_cpu = FlowSampler(params=params, **kw).sample_from(batch, x0)
    rel = float(torch.linalg.vector_norm(on_card.cpu() - on_cpu)
                / torch.linalg.vector_norm(on_cpu))
    print(f"whole path, card kernels vs CPU plain (2 layers, f32, euler NFE 4): "
          f"relative L2 {rel:.3e} (limit 1e-4)")
    if not rel <= 1e-4:
        raise SystemExit(f"whole path: relative L2 {rel} over 1e-4")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.ns_update import ns_update as nu

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True).stdout.strip()
    print(card)
    print(f"torch {torch.__version__} (CUDA {torch.version.cuda}), "
          f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")

    t0 = time.perf_counter()
    seconds = build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"({', '.join(f'{k} {v:.1f} s' for k, v in seconds.items()) or 'cached'})")

    rows = {"ns_update": ns_update_cases(dev), "flash_attention": flash_cases(dev)}
    for name, cases in rows.items():
        for r in cases:
            print(f"{name} [{r['shape']}]: err {r['max_abs_err']:.3e}, "
                  f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                  f"library {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                  f"({r['bound_by']})")

    counters = {"ns_update": nu.COUNTER, "flash_attention": fa.COUNTER}
    launches = main_path(dev, counters)
    whole_path_against_cpu(dev, counters)

    meta = {
        "ns_update": ("src/repro_torch/kernels/csrc/ns_update.cu",
                      "src/repro/kernels/ns_update/ns_update.py:36"),
        "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention/flash_attention.py:68"),
    }
    kernels = []
    for name, (source, replaces) in meta.items():
        main_case = rows[name][0]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "shape": main_case["shape"],
                        **{k: main_case[k] for k in ("max_abs_err", "ms", "plain_ms",
                                                     "bound_ms", "bound_by",
                                                     "library_ms")}})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
