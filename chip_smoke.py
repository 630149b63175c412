#!/usr/bin/env python3
"""Drive the port's paths on an NVIDIA card; hold every CUDA kernel against
its plain PyTorch version.

    python3 chip_smoke.py          # from the repository root, one card

Phases (any failure ends the run with a non-zero exit and no last line):

1. Device: the card's name and power limit, as nvidia-smi prints them.
2. Build: every source in src/repro_torch/kernels/csrc, one nvcc each, all
   started together, into build/repro_torch; each library's kernels,
   registers and spill bytes from ptxas' report.
3. Kernels against their plain versions on the card, at the main paths'
   shapes and a few others, with CUDA-event timing (100 launches after a
   warm-up; 10 for the plain gated linear recurrence) of the kernel, the
   plain version and the one PyTorch call that computes the same function
   where there is one (timed as a yardstick only; the port never calls it).
   ns_update is also timed at the solver's per-step calls (U[:1] and U[:8]
   of an NFE-8 request), and its device time and addmv's are read from
   torch.profiler beside the host-inclusive times. Flash attention prints
   its achieved TFLOP/s and kernel / bound.
   Paged attention has no such call: a dense SDPA over a pre-gathered copy
   is timed beside it, labelled "dense SDPA, gather excluded"; its device
   time is read from torch.profiler at the decode cell and the long rows,
   beside the host-inclusive time. gla_scan has
   none either, and is held against its step-by-step oracle, taken in f64
   on the same inputs; each case prints which of its two kernels ran
   (tensor-core for bf16 q, k, v with dk, dv multiples of 16 up to 128 and a
   chunk of 16, 32 or 64; CUDA-core otherwise) and fails if the library's
   choice differs from that rule. Its bound takes the peak of the type the
   products run in (bf16 for bf16 inputs), with the f32 CUDA-core count
   beside it. TF32 is off.
3c. Backward kernels against their plain versions on the same card inputs:
   the ns_update backward at the flow cell's k = 1 and k = 8 live rows (and
   bf16, a ragged D), its dot products held to TOL times the sum of their
   terms' magnitudes; the flash backward in bf16 and f32 at the flow cell's
   shape, non-causal, at a ragged L and at small GQA shapes (bf16 under
   FLASH_BWD_BF16, f32 under 4 TOL), each after the forward kernel's lse is
   held against the plain log-sum-exp. Timed (CUDA events) beside the plain
   version and, for flash, torch autograd of SDPA's backward (a yardstick
   only); flash prints achieved TFLOP/s at the algorithm's 10 hd flops a
   kept pair and at the executed count (20 hd in bf16: S and dP in both
   passes, P and dS in two parts; 14 in f32), kernel / bound, and the device
   time of each pass (dq, dk/dv) from torch.profiler by kernel name; the
   ns_update backward its device time at the flow cell.
4. Flow path: ``repro_torch.launch.serve.main`` with yi-6b at full width
   (32 layers, bf16, random weights from a seeded generator on the card),
   NFE 8, batch 4, sequence 1024, 3 requests. Launch counts must be exact.
4b. Baselines served at full width: for each of ddim, dpm2m and edm_heun
   (BASELINES), ``SolverSpec(name, 8).build`` for yi-6b's fm_ot field, saved
   as a baseline ``ns`` artifact under build/chip_smoke/ and served by
   ``serve.main`` with phase 4's flags plus ``--requests 2
   --solver-artifact`` (``FlowSampler.from_artifact``). Each request must
   launch ns_update 8 and flash attention 256 times, exactly; the zoo must
   report loads=1 distills=0, "no retraining" be printed, the served
   NSParams equal the built ones to the bit and the latents be finite.
   Each request's ms is printed beside the card's name and power limit.
5. The flow path on the card (kernels) against the CPU (plain versions):
   yi-6b width cut to 2 layers, f32, euler NFE 4, relative L2 <= 1e-4.
5b. The new solver paths on the card against the CPU, phase 5's model and
   limit: ddim, dpm2m and edm_heun at NFE 8 under fm_ot and vp (each 8
   ns_update and 16 flash launches), midpoint with sigma0 = 2, and a
   BST-Euler solver at NFE 4 with random knots, once run directly
   (``taxonomy.run_direct``: 8 flash launches, no ns_update) and once
   through its ``to_ns`` parameters sampled by ``ns_sample`` (4 ns_update
   launches), both against the CPU's direct run. Each case prints its error
   (the baselines beside their largest |a| and |b|); all are run before a
   failure ends the phase.
6. Decode path: ``repro_torch.launch.serve.main`` in decode mode, yi-6b at
   full width, 16 requests through the paged gateway with the paged kernel.
   Every request must finish at its length with in-vocabulary tokens, no
   request may fail, every page must return to the pool, and paged
   attention must launch 32 times per ``decode_apply`` call (counted apart
   from the kernel's own counter); the flow kernels launch 0 times.
6b. Long-row decode step: the same yi-6b weights at full width over a paged
   state of 8 rows of 256 pages of 16 (the decode cell's f32 slot state,
   ~4.3 GB), each row on its own shuffled pages past the trash page 0 with
   seeded random K/V, at positions LONG_LENGTHS - 1. One ``decode_apply``
   call with the paged kernel and one with the reference's dense gather are
   timed (CUDA events, 5 calls after 2 warm-up calls), with the kernel's
   device time from torch.profiler; the kernel launches exactly 32 times a
   call. With bf16 weights the dense gather rounds scores and softmax
   weights to bf16 (the reference's rounding order), so the two paths'
   logits are compared, by phase 7's rule (relative L2 <= 1e-4, the same
   greedy tokens), on an f32 copy of the same weights; the bf16 difference
   is printed beside it.
7. The decode path on the card (kernel) against the CPU (plain version):
   the same 2-layer f32 model and the same gateway requests; every step's
   logits within relative L2 1e-4 and the same greedy tokens.
8. Flow path of rwkv6-7b at full width (32 layers, bf16), as phase 4, after
   the yi-6b weights are freed: gla_scan 32 x 8 x 3 = 768 launches,
   ns_update 24, the attention kernels 0.
9. Phase 5 for rwkv6-7b: its width cut to 2 layers, f32; gla_scan launches
   2 x 4 times on the card, the CPU runs the plain chunked form.
10. Decode path of rwkv6-7b at full width: 8 requests through the gateway
    on 4 slots, max_tokens cycling 32/16; every request finishes at its
    length with in-vocabulary tokens and no kernel launches (decode steps
    the recurrence in plain torch, as the reference does).
11. Phase 7 for rwkv6-7b's 2-layer f32 model.
12. Distillation at full width: ``repro_torch.launch.serve.main`` with
    yi-6b, NFE 8, batch 4, seq 1024, ``--bns-iters`` DISTILL_ITERS, 2
    requests and ``--solver-artifact`` BNS_ARTIFACT (deleted first, so the
    solver zoo misses and distils): RK45 pairs (train and val), the initial
    solver's val PSNR, DISTILL_ITERS training iterations (each layer
    recomputed in the backward), the final validation, the artifact saved
    and reloaded (no launches), the requests with the reloaded solver. The
    zoo must report distills=1. Launch counts must be exact. With R the RK45 evaluations of both
    solves and K = DISTILL_ITERS: flash forward 32 (R + 8 + 8 + 2 * 8) for
    the no-grad calls plus 32 * 8 * 2 * K in training (every layer's forward
    and its recompute; the first velocity call of a step also differentiates,
    since t_0 is an entry of the time grid built from theta), flash backward
    32 * 8 * K, ns_update forward 8 (1 + 1 + 2 + K), ns_update backward 8 K:
    an iteration is 512 flash forward, 256 flash backward, 8 and 8
    ns_update launches, a request 256 flash forward and 8 ns_update. Loss and
    PSNR finite, the distilled val PSNR at least the initial solver's (with K
    under val_every, the final validation is the only one).
12b. The artifact reload: phase 12's flags again, in a fresh ``main``
    call. It must print "no retraining", report zoo loads=1 and distills=0,
    launch exactly what 2 requests launch (flash forward 32 x 8 x 2, ns_update
    16, no backward kernel, no RK45 evaluation), serve NSParams equal to
    phase 12's to the bit and give both requests' latents equal to phase
    12's to the bit (same seeds, weights and deterministic kernels).
12c. Anytime at full width: yi-6b, ``--budgets 4,8 --request-budgets
    4,8,16``, batch 4, seq ANYTIME_SEQ, ``--bns-iters`` ANYTIME_ITERS, 3
    requests, ``--solver-artifact`` ANYTIME_ARTIFACT (deleted first). With R
    the RK45 evaluations of both solves and K = ANYTIME_ITERS: flash forward
    32 (R + 8 + 8 + 20) for the no-grad calls (the initial solver's and the
    final validation's shared trajectory, 8 evaluations each; the requests
    at 4, 8 and 16 -> 8 NFE) plus 32 x 8 x 2 K in training, flash backward
    32 x 8 K, ns_update 9 + 9 + 20 + 9 K (a trajectory runs 8 intermediate
    rules and the budget-4 exit; a request at m NFE m rules), ns_update
    backward 9 K: an iteration is 512 flash forward, 256 flash backward, 9
    and 9 ns_update launches. The nearest-budget WARNING for 16 is printed
    exactly once; loss and PSNR finite. Then, on the served
    ``AnytimeFlowSampler`` and one seeded x0, each equal to the bit:
    ``sample_all_from(x0)[m]`` and ``sample_from(x0, m)`` for m in (4, 8);
    ``carry_start`` -> ``carry_extend(4)`` -> ``carry_extend(8)`` and
    ``sample_all_from``.
12d. BST distilled at full width: yi-6b's field with each layer recomputed
    (as ``serve._distill_artifact`` builds it), one ``bns.generate_pairs``
    call of BST_PAIRS = 8 samples at seq BST_SEQ = 256 (one RK45 solve; the
    conditioning batch of 4 rows taken twice, so the 4 train and 4 val rows
    share it; flash forward 32 per evaluation), Euler's val PSNR through
    ``ns_sample`` (8 ns_update, 256 flash), then ``SolverSpec("euler", 8,
    mode="bst").distill`` for BST_ITERS = 4 full-batch iterations: flash
    forward 512 and backward 256 an iteration plus 256 forward for the
    final validation, and no ns_update launch (``run_direct`` bypasses it).
    Loss and PSNR finite, the BST val PSNR at least Euler's - 0.2 dB (the
    reference's BST claim) and above Euler's, the trained knots off
    ``identity_bst(8, "euler")`` (which samples as Euler does, so a lost
    gradient would pass the claim alone), the ``bst`` artifact saved and reloaded
    bit-equal and its ``ns_params`` refused with TypeError. Prints each
    iteration's ms (``bns.fit``'s stamps) and the peak memory.
13. The gradient on the card against the CPU: yi-6b's width cut to 2 layers,
    f32, euler NFE 4, on shared pairs (numpy, seeded), each layer recomputed:
    _loss_fn and d loss / d(time_logits, a, b) at theta0, relative L2 <= 1e-4
    (phase 5's rule), with exactly 16 flash forward, 8 flash backward, 4 + 4
    ns_update launches; then theta after DISTILL_CHECK_STEPS train_solver
    steps. Adam's first steps are ~lr sign(g) per component, so a component
    whose gradient is near 0 can step either way: components whose CPU
    gradient at theta0 is at least 1e-3 of its largest must agree to 1e-3 of
    the largest step (lr per step), the others to the most a flipped sign can
    move them (2 lr per step).
13b. Phase 13 for the anytime loss: the same 2-layer f32 model and pairs,
    budgets (2, 4), theta the nested initial solver jittered with numpy from
    a seed: ``anytime_loss`` and its gradient in every field of
    ``AnytimeParams``, card against CPU, relative L2 <= 1e-4, with exactly 16
    flash forward, 8 flash backward, 5 + 5 ns_update launches (4
    intermediate rules and the budget-2 exit).
13c. Phase 13 for BST, the gradient that phase 12d trains on: the same
    2-layer f32 model and pairs, BST-Euler at NFE 4, knots the identity
    jittered with numpy from a seed: ``_loss_fn`` through ``bst_sampler``
    (``run_direct`` under autograd into ``materialize_bst``) and its gradient
    in every field of ``BSTParams``, card against CPU, relative L2 <= 1e-4,
    with exactly 16 flash forward, 8 flash backward and no ns_update launch.
14. The script's wall time, one JSON line listing the kernels (the
    ns_update and flash entries, forward and backward, with phases 4b, 5b,
    12b, 12c, 12d, 13b and 13c's launches and ms beside the main path's), then
    the last line.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import msgpack
import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
T_START = time.perf_counter()
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}   # tests/test_kernels.py
# bf16 flash attention against its plain version. The kernel rounds the
# softmax weights P to bf16 before P·V and the output to bf16; the plain
# version keeps P in f32. Both limits must hold: elementwise
# |err| <= atol + rtol |ref|, and the relative L2 error of each output row
# (over the head dim) <= row_rel_l2, which catches a fault confined to late
# rows, where |o| is small. scripts/flash_fault_check.py shows the sound
# kernel inside both and planted faults outside.
FLASH_BF16 = {"atol": 4e-3, "rtol": 2e-2, "row_rel_l2": 1e-2}
# bf16 paged attention against its plain version: both keep scores, weights
# and sums in f32 and round only the output to bf16, so the two differ by at
# most one bf16 ulp of |o|, which is <= 2**-7 |o| (atol covers outputs near 0).
PAGED_BF16 = {"rel": 2.0 ** -7, "atol": 1e-6}
# bf16 flash backward against its plain version (phase 3c). Both take the same
# bf16 q, k, v, o, dO and the kernel's lse, sum in f32 (the kernel's P and dS
# in two bf16 parts, ~16 bits) and round only dq, dk, dv to bf16, so they
# differ by one bf16 rounding step at most: |err| <= atol + 2^-7 |ref|
# elementwise (card readings: 0.88 of it for an exact-f32 first version, 0.97
# for the tensor-core kernel), and each row's relative L2 error <= row_rel_l2,
# over max(|ref row|, atol sqrt(hd)) (causal row 0 of dq is exactly 0: its one
# key gives dS = P (dP - D) = 0); readings 1.7e-3 and 2.6e-3.
# scripts/flash_bwd_fault_check.py shows the sound kernel inside and planted
# faults outside.
FLASH_BWD_BF16 = {"atol": 1e-3, "rtol": 2 ** -7, "row_rel_l2": 4e-3}
HBM_BYTES_PER_S = 3.35e12                          # H100 SXM data sheet
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}  # CUDA-core f32, dense bf16
NFE, BATCH, SEQ, REQUESTS = 8, 4, 1024, 3
DECODE_ARGS = ["--arch", "yi-6b", "--mode", "decode", "--full", "--gateway",
               "--page-size", "16", "--paged-kernel", "--max-slots", "8", "--slots", "256",
               "--requests", "16", "--decode-lengths", "128,32,64,16",
               "--prefill-chunk", "64"]
RWKV_DECODE_ARGS = ["--arch", "rwkv6-7b", "--mode", "decode", "--full", "--gateway",
                    "--max-slots", "4", "--requests", "8", "--decode-lengths", "32,16"]
LONG_LENGTHS = [4096, 3001, 2048, 1, 777, 4095, 1500, 3333]   # positions a row
LAYERS = 32                                        # yi-6b and rwkv6-7b
DISTILL_ITERS, DISTILL_REQUESTS = 8, 2             # phase 12
DISTILL_CHECK_STEPS, DISTILL_CHECK_LR = 3, 1e-3    # phase 13
BNS_ARTIFACT = ROOT / "build" / "chip_smoke" / "bns_nfe8.msgpack"          # phases 12, 12b
ANYTIME_ARTIFACT = ROOT / "build" / "chip_smoke" / "anytime_4_8.msgpack"   # phase 12c
ANYTIME_SEQ, ANYTIME_ITERS, ANYTIME_BUDGETS = 256, 4, (4, 8)              # phase 12c
ANYTIME_REQUEST_BUDGETS = (4, 8, 16)
BASELINES = ("ddim", "dpm2m", "edm_heun")                                    # phases 4b, 5b
BASELINE_REQUESTS = 2                                                        # phase 4b
BST_SEQ, BST_PAIRS, BST_ITERS = 256, 8, 4                                    # phase 12d
BST_ARTIFACT = ROOT / "build" / "chip_smoke" / "bst_euler_nfe8.msgpack"
VOCAB = {"yi-6b": 64000, "rwkv6-7b": 65536}
KERNELS = ("ns_update", "flash_attention", "paged_attention", "gla_scan", "ns_update_bwd",
           "flash_attention_bwd")
# the flash backward's passes by kernel name (in bf16 and f32 alike)
BWD_PASSES = ("flash_bwd_dq", "flash_bwd_dkdv")


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


def device_ms(fn, kernel: str | None, iters: int = 100) -> float | None:
    """Mean device time per call of ``fn`` from torch.profiler: the kernels
    whose name holds ``kernel`` (every kernel if None), over ``iters`` calls.
    None where the trace holds no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA and (kernel is None or kernel in e.name))
    return us / iters / 1e3 if us else None


def device_ms_by_kernel(fn, kernels: tuple, iters: int = 20) -> dict:
    """Mean device time per call of ``fn`` from torch.profiler, for each name
    in ``kernels``: the kernels whose name holds it (None where none ran)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = dict.fromkeys(kernels, 0.0)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            for k in kernels:
                if k in e.name:
                    us[k] += e.time_range.elapsed_us()
    return {k: v / iters / 1e3 if v else None for k, v in us.items()}


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
        rows.append(ns_update_row(f"n={n} B={B} D={D} {str(dtype)[6:]}", err,
                                  x0, u, a, w, timed_on_device=not rows))
    # the main path's calls: step i of an NFE-8 request reads the i+1 rows the
    # solver has filled, U[:i+1], with the weights b[i, :i+1] (views)
    x0 = torch.randn((BATCH, SEQ * 64), generator=g, device=dev)
    U = torch.randn((NFE, BATCH, SEQ * 64), generator=g, device=dev)
    a = torch.randn((NFE,), generator=g, device=dev)
    b = torch.randn((NFE, NFE), generator=g, device=dev)
    for live in (1, NFE):
        u, w = U[:live], b[live - 1, :live]
        err = check_close(f"ns_update step {live} of {NFE}", ns_update(x0, u, a[live - 1], w),
                          ns_update_ref(x0, u, a[live - 1], w), atol=TOL[torch.float32] * live,
                          rtol=TOL[torch.float32])
        rows.append(ns_update_row(f"step {live} of n={NFE}: U[:{live}] B={BATCH} "
                                  f"D={SEQ * 64} float32", err, x0, u, a[live - 1], w,
                                  timed_on_device=True))
    return rows


def ns_update_row(shape, err, x0, u, a, w, timed_on_device: bool) -> dict:
    """Host-inclusive back-to-back times of the kernel, its plain version and
    addmv; with ``timed_on_device`` also the kernel's and addmv's device time
    from the profiler."""
    from repro_torch.kernels.ns_update.ns_update import ns_update
    from repro_torch.kernels.ns_update.ref import ns_update_ref

    n, N = u.shape[0], x0.numel()
    beta, wl, xf, uf = a.item(), w.to(x0.dtype), x0.view(-1), u.view(n, -1).t()
    b_ms, b_by = bound((n + 2) * N * x0.element_size(), 2 * (n + 1) * N, x0.dtype)
    row = dict(shape=shape, max_abs_err=err,
               ms=time_ms(lambda: ns_update(x0, u, a, w)),
               plain_ms=time_ms(lambda: ns_update_ref(x0, u, a, w)),
               library_ms=time_ms(lambda: torch.addmv(xf, uf, wl, beta=beta)),
               bound_ms=b_ms, bound_by=b_by)
    if timed_on_device:
        row["device_ms"] = device_ms(lambda: ns_update(x0, u, a, w), "ns_update_kernel")
        row["library_device_ms"] = device_ms(lambda: torch.addmv(xf, uf, wl, beta=beta), None)
    return row


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
            (2, 8, 2, 512, 80, torch.float32, True),
            (2, 8, 2, 512, 64, torch.bfloat16, True),          # hd 64
            (2, 8, 2, 512, 80, torch.bfloat16, True),          # hd 80: 32-byte swizzle
            (BATCH, 32, 4, 1, 128, torch.bfloat16, True)]:     # one position
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
        flops = 4 * hd * pairs * B * H
        b_ms, b_by = bound((2 * B * H * L * hd + 2 * B * KV * L * hd) * size, flops, dtype)
        ms = time_ms(lambda: flash_attention(q, k, v, causal=causal))
        rows.append(dict(
            shape=f"B={B} H={H} KV={KV} L={L} hd={hd} {str(dtype)[6:]} "
                  f"{'causal' if causal else 'full'}", max_abs_err=err,
            ms=ms, tflops=flops / ms / 1e9,
            plain_ms=time_ms(lambda: attention_ref(q, k, v, causal=causal)),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=True)),
            bound_ms=b_ms, bound_by=b_by))
    return rows


def ns_update_bwd_cases(dev):
    """Phase 3c: the ns_update backward at the flow cell's shapes (k = 1 and 8
    live rows of B=4 x D=65536), in bf16, at a ragged D and without dx0.
    dU and dx0 are one f32 product each, as in the plain version (limit TOL);
    da and dw are f32 sums over N products, held to TOL times the sum of the
    products' magnitudes (the scale of a reordered f32 sum's error)."""
    from repro_torch.kernels.ns_update.ns_update import ns_update_bwd
    from repro_torch.kernels.ns_update.ref import ns_update_bwd_ref

    g = torch.Generator(device=dev).manual_seed(5)
    rows = []
    for n, B, D, dtype, need_x0 in [(NFE, BATCH, SEQ * 64, torch.float32, False),  # main path
                                    (1, BATCH, SEQ * 64, torch.float32, False),
                                    (NFE, BATCH, SEQ * 64, torch.bfloat16, True),
                                    (20, 3, 1000, torch.float32, True)]:          # ragged D
        x0, grad = (torch.randn((B, D), generator=g, device=dev).to(dtype) for _ in "xg")
        u = torch.randn((n, B, D), generator=g, device=dev).to(dtype)
        a = torch.randn((), generator=g, device=dev)
        w = torch.randn((n,), generator=g, device=dev)
        shape = f"k={n} B={B} D={D} {str(dtype)[6:]}{' dx0' if need_x0 else ''}"
        got = ns_update_bwd(grad, x0, u, a, w, need_x0=need_x0)
        ref = ns_update_bwd_ref(grad, x0, u, a, w, need_x0=need_x0)
        err = 0.0
        for what, x, r in zip(("dx0", "du"), got[:2], ref[:2]):
            if need_x0 or what != "dx0":
                err = max(err, check_close(f"ns_update_bwd [{shape}] {what}", x, r,
                                           atol=TOL[dtype], rtol=TOL[dtype]))
        gf = grad.float()
        scales = torch.cat([(x0.float() * gf).abs().sum().reshape(1),
                            torch.tensordot(u.float().abs(), gf.abs(), dims=2)])
        dots, dots_ref = torch.cat([got[2].reshape(1), got[3]]), torch.cat(
            [ref[2].reshape(1), ref[3]])
        ratio = float(((dots - dots_ref).abs() / (TOL[torch.float32] * scales)).max())
        if not ratio <= 1:
            raise SystemExit(f"ns_update_bwd [{shape}]: da, dw vs plain at {ratio:.3f} of "
                             f"the limit (TOL x the sum of |terms|)")
        err = max(err, float((dots - dots_ref).abs().max()))
        N, size = x0.numel(), x0.element_size()
        b_ms, b_by = bound((2 + 2 * n + need_x0) * N * size, (3 * n + 2 + need_x0) * N, dtype)
        rows.append(dict(
            shape=shape, max_abs_err=err, dot_limit_ratio=ratio,
            ms=time_ms(lambda: ns_update_bwd(grad, x0, u, a, w, need_x0=need_x0)),
            plain_ms=time_ms(lambda: ns_update_bwd_ref(grad, x0, u, a, w, need_x0=need_x0)),
            library_ms=None, bound_ms=b_ms, bound_by=b_by))
        if not len(rows) > 2:
            rows[-1]["device_ms"] = device_ms(
                lambda: ns_update_bwd(grad, x0, u, a, w, need_x0=need_x0), "ns_update_bwd")
    return rows


def flash_bwd_errors(out: torch.Tensor, ref: torch.Tensor) -> dict:
    """Largest |err|, largest |err| / (atol + rtol |ref|), and largest row
    relative L2 error over max(|ref row|, atol sqrt(hd)), under the
    backward's bf16 limit."""
    atol, rtol = FLASH_BWD_BF16["atol"], FLASH_BWD_BF16["rtol"]
    ref = ref.float()
    err = (out.float() - ref).abs()
    floor = atol * ref.shape[-1] ** 0.5
    row = (torch.linalg.vector_norm(err, dim=-1)
           / torch.linalg.vector_norm(ref, dim=-1).clamp_min(floor))
    return {"max_abs": float(err.max()),
            "ratio": float((err / (atol + rtol * ref.abs())).max()),
            "row_rel_l2": float(row.max())}


def flash_bwd_passes(e: dict) -> bool:
    return e["ratio"] <= 1 and e["row_rel_l2"] <= FLASH_BWD_BF16["row_rel_l2"]


def flash_bwd_cases(dev):
    """Phase 3c: the flash backward against its plain version on the same
    inputs (q, k, v, dO drawn on the card; o and lse from the forward
    kernel, whose lse is first held against the plain log-sum-exp), at the
    flow cell's shape in bf16 and f32, non-causal, at a ragged L and at small
    GQA shapes. Timed beside its plain version and torch autograd of SDPA's
    backward (a yardstick only: the port never calls it)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention,
        flash_attention_bwd,
    )
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref, attention_lse_ref

    g = torch.Generator(device=dev).manual_seed(6)
    bf16, f32 = torch.bfloat16, torch.float32
    rows = []
    for B, H, KV, L, dtype, causal in [(BATCH, 32, 4, SEQ, bf16, True),     # main path
                                       (BATCH, 32, 4, SEQ, f32, True),
                                       (BATCH, 32, 4, SEQ, bf16, False),
                                       (BATCH, 32, 4, 1000, bf16, True),    # ragged L
                                       (BATCH, 32, 4, 1000, f32, False),
                                       (2, 8, 2, 77, f32, True),
                                       (1, 4, 4, 33, bf16, False)]:
        hd = 128
        q, do = (torch.randn((B, L, H, hd), generator=g, device=dev).to(dtype).transpose(1, 2)
                 for _ in "qo")
        k, v = (torch.randn((B, L, KV, hd), generator=g, device=dev).to(dtype).transpose(1, 2)
                for _ in "kv")
        shape = (f"B={B} H={H} KV={KV} L={L} hd={hd} {str(dtype)[6:]} "
                 f"{'causal' if causal else 'full'}")
        o, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
        lse_ref = attention_lse_ref(q, k, causal=causal)
        lse_ratio = float(((lse - lse_ref).abs() / (4 * TOL[f32] * (1 + lse_ref.abs()))).max())
        if not lse_ratio <= 1:
            raise SystemExit(f"flash_attention [{shape}]: lse vs plain at {lse_ratio:.3f} of "
                             "the limit (4 TOL (1 + |lse|))")
        got = flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
        ref = attention_bwd_ref(q, k, v, o, lse, do, causal=causal)
        err, ratio = 0.0, 0.0
        for what, x, r in zip(("dq", "dk", "dv"), got, ref):
            if not bool(torch.isfinite(x.float()).all()):
                raise SystemExit(f"flash_attention_bwd [{shape}] {what}: non-finite")
            if dtype == bf16:
                e = flash_bwd_errors(x, r)
                if not flash_bwd_passes(e):
                    raise SystemExit(f"flash_attention_bwd [{shape}] {what}: kernel vs plain "
                                     f"outside the bf16 limit {FLASH_BWD_BF16}: {e}")
                err, ratio = max(err, e["max_abs"]), max(ratio, e["ratio"])
            else:
                err = max(err, check_close(f"flash_attention_bwd [{shape}] {what}", x, r,
                                           atol=TOL[f32] * 4, rtol=TOL[f32] * 4))
        pairs = L * (L + 1) // 2 if causal else L * L
        size = q.element_size()
        flops = 10 * hd * pairs * B * H
        nbytes = (4 * B * H * L * hd + 4 * B * KV * L * hd) * size + B * H * L * 4
        b_ms, b_by = bound(nbytes, flops, dtype)
        ms = time_ms(lambda: flash_attention_bwd(q, k, v, o, lse, do, causal=causal), iters=20)
        passes = device_ms_by_kernel(
            lambda: flash_attention_bwd(q, k, v, o, lse, do, causal=causal), BWD_PASSES)
        executed = (20 if dtype == bf16 else 14) * hd * pairs * B * H
        qs, ks, vs = (t.detach().requires_grad_(True) for t in (q, k, v))
        out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal, enable_gqa=True)
        rows.append(dict(
            shape=shape, max_abs_err=err, limit_ratio=ratio, lse_limit_ratio=lse_ratio,
            ms=ms, tflops=flops / ms / 1e9, executed_tflops=executed / ms / 1e9,
            pass_device_ms=passes,
            plain_ms=time_ms(lambda: attention_bwd_ref(q, k, v, o, lse, do, causal=causal),
                             iters=5, warmup=1),
            library_ms=time_ms(lambda: torch.autograd.grad(out, (qs, ks, vs), do,
                                                           retain_graph=True), iters=20),
            bound_ms=b_ms, bound_by=b_by))
        del out, qs, ks, vs, got, ref
    return rows


def paged_errors(out: torch.Tensor, ref: torch.Tensor) -> dict:
    """Largest |err|, and its largest ratio to the limit of the output type."""
    err = (out.float() - ref.float()).abs()
    if out.dtype == torch.float32:
        limit = TOL[torch.float32] * 4 * (1 + ref.abs())
    else:
        limit = PAGED_BF16["rel"] * ref.float().abs() + PAGED_BF16["atol"]
    return {"max_abs": float(err.max()), "ratio": float((err / limit).max())}


def paged_inputs(g, dev, B, KV, G, hd, ps, nb, q_dtype, page_dtype, lengths):
    """q, a K and V pool whose rows own nb shuffled pages past the trash page
    0, the block table and the lengths, made on the card from ``g``."""
    num_pages = 1 + B * nb
    q = torch.randn((B, KV, G, hd), generator=g, device=dev).to(q_dtype)
    k = torch.randn((num_pages, ps, KV, hd), generator=g, device=dev).to(page_dtype)
    v = torch.randn((num_pages, ps, KV, hd), generator=g, device=dev).to(page_dtype)
    perm = torch.randperm(num_pages - 1, generator=g, device=dev)[:B * nb] + 1
    table = perm.reshape(B, nb).to(torch.int32)
    return q, k, v, table, torch.tensor(lengths, dtype=torch.int32, device=dev)


def poison_tails(k, v, table, lengths) -> None:
    """Garbage (+-1e4, alternating) in each row's own pages past its length."""
    ps, nb = k.shape[1], table.shape[1]
    for b, n in enumerate(lengths):
        pos = torch.arange(n, nb * ps, device=k.device)
        page, off = table[b, pos // ps].long(), pos % ps
        sign = (pos % 2 * 2 - 1).to(k.dtype)[:, None, None]
        k[page, off] = 1e4 * sign
        v[page, off] = -1e4 * sign


def paged_cases(dev):
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.paged_attention import paged_attention
    from repro_torch.kernels.flash_attention.ref import paged_attention_ref

    g = torch.Generator(device=dev).manual_seed(2)
    bf16, f32 = torch.bfloat16, torch.float32
    decode_lengths = [129, 1, 17, 64, 100, 33, 128, 16]
    rows = []
    for B, KV, G, hd, ps, nb, q_dtype, page_dtype, lengths, poison in [
            (8, 4, 8, 128, 16, 16, bf16, f32, decode_lengths, False),   # the decode cell
            (8, 4, 8, 128, 16, 256, bf16, bf16, LONG_LENGTHS, False),   # long rows
            (8, 4, 8, 128, 16, 256, bf16, f32, LONG_LENGTHS, False),
            (2, 2, 2, 64, 8, 4, f32, f32, [2, 12], False),              # tests/test_kernels.py
            (3, 1, 4, 32, 16, 2, f32, f32, [1, 19, 32], False),
            (1, 4, 1, 64, 8, 3, f32, f32, [9], False),
            (4, 4, 8, 128, 16, 16, bf16, f32, [5, 37, 1, 200], True)]:  # poisoned tails
        q, k, v, table, lens = paged_inputs(g, dev, B, KV, G, hd, ps, nb, q_dtype,
                                            page_dtype, lengths)
        shape = (f"B={B} KV={KV} G={G} hd={hd} ps={ps} nb={nb} q {str(q_dtype)[6:]} "
                 f"pages {str(page_dtype)[6:]} lengths<={max(lengths)}")
        out = paged_attention(q, k, v, table, lens)
        if poison:
            poison_tails(k, v, table, lengths)
            if not torch.equal(paged_attention(q, k, v, table, lens), out):
                raise SystemExit(f"paged_attention [{shape}]: positions past the "
                                 "length leak into the output")
            shape += " poisoned"
        ref = paged_attention_ref(q, k, v, table, lens)
        e = paged_errors(out, ref)
        if not e["ratio"] <= 1:
            raise SystemExit(f"paged_attention [{shape}]: kernel vs plain outside the "
                             f"limit (f32: 4x TOL, bf16: {PAGED_BF16}): {e}")
        kept = [min(n, nb * ps) for n in lengths]
        page_bytes = sum(kept) * KV * hd * 2 * k.element_size()
        io_bytes = 2 * q.numel() * q.element_size() + 4 * (B + sum(-(-n // ps) for n in kept))
        b_ms, b_by = bound(page_bytes + io_bytes, 4 * hd * G * KV * sum(kept), f32)
        # yardstick: one SDPA over a dense copy gathered beforehand
        L = nb * ps
        kd = k[table.long()].reshape(B, L, KV, hd).transpose(1, 2)
        vd = v[table.long()].reshape(B, L, KV, hd).transpose(1, 2)
        qd = q.reshape(B, KV * G, 1, hd).to(page_dtype)
        mask = (torch.arange(L, device=dev)[None, :] < lens[:, None])[:, None, None, :]
        rows.append(dict(
            shape=shape, max_abs_err=e["max_abs"], limit_ratio=e["ratio"],
            ms=time_ms(lambda: paged_attention(q, k, v, table, lens)),
            plain_ms=time_ms(lambda: paged_attention_ref(q, k, v, table, lens)),
            library_ms=None,
            yardstick_ms=time_ms(lambda: F.scaled_dot_product_attention(
                qd, kd, vd, attn_mask=mask, enable_gqa=True)),
            bound_ms=b_ms, bound_by=b_by))
        if len(rows) <= 3:    # the decode cell and the long rows
            rows[-1]["device_ms"] = device_ms(
                lambda: paged_attention(q, k, v, table, lens), "paged_attention")
        del kd, vd
    return rows


def gla_flops(L: int, chunk: int, dk: int, dv: int, inclusive: bool) -> float:
    """Operations one (row, head) needs, chunk by chunk: the kept (lower)
    triangle of the score cube (a difference, two products and a sum per
    element) and of the intra-chunk product, the cross-chunk product and the
    state update. Exponentials are not counted."""
    total = 0.0
    for l0 in range(0, L, chunk):
        n = min(chunk, L - l0)
        pairs = n * (n + 1) // 2 if inclusive else n * (n - 1) // 2
        total += 4 * pairs * dk + 2 * pairs * dv + 4 * n * dk * dv
    return total


def gla_kernel_rule(dtype: torch.dtype, L: int, dk: int, dv: int, chunk: int) -> str:
    """The selection rule csrc/gla_scan.cu states, written out apart from it:
    bf16 q, k, v with dk and dv multiples of 16 up to 128 and a chunk (cut to
    L) of 16, 32 or 64 take the tensor-core kernel."""
    mma = (dtype == torch.bfloat16 and dk % 16 == 0 and dv % 16 == 0 and dk <= 128
           and dv <= 128 and min(chunk, L) in (16, 32, 64))
    return "tensor-core" if mma else "CUDA-core"


def gla_cases(dev):
    from repro_torch.kernels.gla_scan.gla_scan import gla_scan, kernel_for
    from repro_torch.kernels.gla_scan.ref import gla_ref
    from repro_torch.models.linear_scan import gla_chunked

    g = torch.Generator(device=dev).manual_seed(3)
    f32, bf16 = torch.float32, torch.bfloat16
    rows = []
    # (B, L, H, dk, dv, chunk, inclusive, qkv dtype, ld dtype, decay, scalar decay, s0)
    # decay: "model" draws ld as rwkv6 does (-exp(-6 + small noise)), a number
    # scales -|N(0, 1)| as tests/test_kernels.py does (0.5 moderate, 30 strong)
    cases = [(BATCH, SEQ, 64, 64, 64, 64, False, bf16, f32, "model", False, False),  # main path
             (BATCH, SEQ, 64, 64, 64, 64, False, bf16, f32, 0.5, False, False),
             (BATCH, SEQ, 64, 64, 64, 64, False, f32, f32, "model", False, False),
             (2, SEQ, 80, 64, 64, 64, True, bf16, f32, 0.5, True, False),   # mamba2-style
             (BATCH, 1000, 64, 64, 64, 64, False, bf16, f32, "model", False, False),
             (2, 256, 8, 64, 64, 64, False, f32, f32, 0.5, False, True),    # given s0
             (2, 256, 8, 64, 64, 64, True, bf16, bf16, 0.5, False, True),
             (1, 128, 2, 16, 16, 32, False, f32, f32, 30.0, False, False),  # strong decay
             (1, 128, 2, 16, 16, 32, False, bf16, f32, 30.0, False, False),
             (2, 256, 8, 64, 64, 16, False, bf16, f32, "model", False, False),  # chunk 16
             (2, 256, 8, 32, 96, 64, True, bf16, f32, 0.5, False, True)]     # dk != dv
    for dtype in (f32, bf16):                        # tests/test_kernels.py sweep
        for L, chunk, inclusive, dk, dv in [(128, 32, True, 64, 64), (128, 32, False, 64, 64),
                                            (96, 16, False, 32, 48), (64, 64, True, 16, 128)]:
            cases.append((2, L, 3, dk, dv, chunk, inclusive, dtype, f32, 0.5, False, False))
    for B, L, H, dk, dv, chunk, inclusive, dtype, ld_dtype, decay, scalar, with_s0 in cases:
        q, k = (torch.randn((B, L, H, dk), generator=g, device=dev).to(dtype) for _ in "qk")
        v = torch.randn((B, L, H, dv), generator=g, device=dev).to(dtype)
        noise = torch.randn((B, L, H, 1 if scalar else dk), generator=g, device=dev)
        ld = (-torch.exp(-6.0 + 0.1 * noise) if decay == "model"
              else -noise.abs() * decay).to(ld_dtype)
        s0 = (torch.randn((B, H, dk, dv), generator=g, device=dev) if with_s0 else None)
        shape = (f"B={B} L={L} H={H} dk={dk} dv={dv} chunk={chunk} "
                 f"{'inclusive' if inclusive else 'exclusive'} qkv {str(dtype)[6:]} "
                 f"ld {str(ld_dtype)[6:]}{' per head' if scalar else ''} decay {decay}"
                 f"{' s0' if with_s0 else ''}")
        kernel = kernel_for(dtype, L, dk, dv, chunk)
        if kernel != gla_kernel_rule(dtype, L, dk, dv, chunk):
            raise SystemExit(f"gla_scan [{shape}]: the library selects the {kernel} kernel, "
                             f"the stated rule the {gla_kernel_rule(dtype, L, dk, dv, chunk)} one")
        shape += f" [{kernel}]"
        o, s = gla_scan(q, k, v, ld, s0, inclusive=inclusive, chunk=chunk)
        if not (bool(torch.isfinite(o.float()).all()) and bool(torch.isfinite(s).all())):
            raise SystemExit(f"gla_scan [{shape}]: non-finite output")
        # the oracle in f64 on the same inputs: over 1024 weakly decayed steps
        # the f32 recurrence drifts from exact by more than the limit itself
        o_ref, s_ref = gla_ref(*(t.double() for t in (q, k, v, ld)),
                               None if s0 is None else s0.double(), inclusive=inclusive)
        # tests/test_kernels.py: atol 20 TOL, rtol TOL; its strong-decay case atol 1e-3
        atol = max(TOL[dtype] * 20, 1e-3 if decay == 30.0 else 0.0)
        err = max(check_close(f"gla_scan [{shape}] o", o, o_ref, atol, TOL[dtype]),
                  check_close(f"gla_scan [{shape}] state", s, s_ref, atol, TOL[dtype]))
        if dtype == f32:
            o32, _ = gla_ref(q, k, v, ld, s0, inclusive=inclusive)
            shape += f" (f32 oracle's own error {float((o32.double() - o_ref).abs().max()):.3e})"
        ld_elems = B * L * H * (1 if scalar else dk)
        nbytes = (2 * q.numel() + v.numel()) * q.element_size() + \
            ld_elems * ld.element_size() + o.numel() * o.element_size() + \
            s.numel() * 4 * (2 if with_s0 else 1)
        # the bound at the peak of the type the products run in (bf16 tensor
        # cores for bf16 q, k, v), and beside it the same count at the f32
        # CUDA-core peak (the table's bound before the tensor-core kernel)
        flops = B * H * gla_flops(L, chunk, dk, dv, inclusive)
        b_ms, b_by = bound(nbytes, flops, dtype)
        b32_ms, b32_by = bound(nbytes, flops, f32)
        rows.append(dict(
            shape=shape, max_abs_err=err, kernel=kernel, bound_f32=(b32_ms, b32_by),
            ms=time_ms(lambda: gla_scan(q, k, v, ld, s0, inclusive=inclusive, chunk=chunk)),
            plain_ms=time_ms(lambda: gla_chunked(q, k, v, ld, s0, inclusive=inclusive,
                                                 chunk=chunk), iters=10, warmup=2),
            library_ms=None, bound_ms=b_ms, bound_by=b_by))
    return rows


def ptxas_summary(name: str, log: Path) -> str:
    """Kernels, registers and spill bytes from the -Xptxas=-v report kept
    beside a library (build.py writes it when it compiles the source)."""
    if not log.exists():
        return f"ptxas {name}: no report (library not built in this run)"
    text = log.read_text()
    regs = [int(x) for x in re.findall(r"Used (\d+) registers", text)]
    spills = sum(int(x) for x in re.findall(r"(\d+) bytes spill stores", text))
    return (f"ptxas {name}: {len(regs)} kernels, {min(regs, default=0)}-"
            f"{max(regs, default=0)} registers, {spills} bytes of spill stores")


def reset(counters) -> None:
    for c in counters.values():
        c.reset()


def free_device_memory(dev) -> None:
    gc.collect()                       # the previous phase's weights go first
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)


def flow_path(dev, counters, arch: str, want: dict):
    """serve.main in flow mode at full width; launch counts must be ``want``."""
    from repro_torch.launch import serve

    free_device_memory(dev)
    reset(counters)
    t0 = time.perf_counter()
    served = serve.main(["--arch", arch, "--mode", "flow", "--full",
                         "--nfe", str(NFE), "--batch", str(BATCH), "--seq", str(SEQ),
                         "--requests", str(REQUESTS), "--bns-iters", "0"])
    wall = time.perf_counter() - t0
    launches = {name: c.launches for name, c in counters.items()}
    if launches != want:
        raise SystemExit(f"{arch} flow path launch counts {launches}, expected {want}")
    if len(served) != REQUESTS:
        raise SystemExit(f"{len(served)} requests answered, expected {REQUESTS}")
    for s in served:
        if s.latents.shape != (BATCH, SEQ, 64) or not bool(torch.isfinite(s.latents).all()):
            raise SystemExit(f"bad latents: shape {tuple(s.latents.shape)}")
        if (s.tokens.shape != (BATCH, SEQ) or int(s.tokens.min()) < 0
                or int(s.tokens.max()) >= VOCAB[arch]):
            raise SystemExit(f"bad tokens: shape {tuple(s.tokens.shape)}")
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"flow path: {arch} full width, NFE {NFE}, batch {BATCH}, seq {SEQ}: "
          f"request ms {[round(s.ms, 3) for s in served]}, launches {launches}, "
          f"peak memory {peak / 2**30:.3f} GiB, main() wall {wall:.3f} s")
    return launches


def small_model(arch: str):
    """The arch's width cut to 2 layers, f32, random weights on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    cfg = dataclasses.replace(get_config(arch), n_layers=2, dtype="float32")
    return cfg, M.init_params(torch.Generator().manual_seed(0), cfg, "cpu")


def whole_path_against_cpu(dev, counters, cfg, params, want: dict):
    from repro_torch.core.schedulers import get_scheduler
    from repro_torch.data.synthetic import DataConfig, SyntheticTokens
    from repro_torch.models import model as M
    from repro_torch.models.transformer import params_to
    from repro_torch.serving.engine import FlowSampler
    from repro_torch.solvers.registry import build_ns

    batch = SyntheticTokens(cfg, DataConfig(batch_size=2, seq_len=128, seed=0),
                            device="cpu").batch(0)
    x0 = np.random.default_rng(0).standard_normal((2, 128, cfg.latent_dim)).astype(np.float32)
    field = M.velocity_field(params, cfg, get_scheduler("fm_ot"), batch)
    kw = dict(cfg=cfg, sched=field.scheduler, solver=build_ns("euler", 4, field))
    before = {name: c.launches for name, c in counters.items()}
    on_card = FlowSampler(params=params_to(params, dev), **kw).sample_from(batch, x0)
    torch.cuda.synchronize(dev)
    ran = {name: c.launches - before[name] for name, c in counters.items()}
    if ran != want:
        raise SystemExit(f"{cfg.name} card run launched {ran}, expected {want}")
    on_cpu = FlowSampler(params=params, **kw).sample_from(batch, x0)
    rel = float(torch.linalg.vector_norm(on_card.cpu() - on_cpu)
                / torch.linalg.vector_norm(on_cpu))
    print(f"whole path, {cfg.name}, card kernels vs CPU plain (2 layers, f32, euler "
          f"NFE 4): relative L2 {rel:.3e} (limit 1e-4)")
    if not rel <= 1e-4:
        raise SystemExit(f"whole path {cfg.name}: relative L2 {rel} over 1e-4")


class PerRequest:
    """Each ``FlowSampler.sample`` call's kernel launches, read from the
    counters around it (the launcher samples each request through it)."""

    def __init__(self, counters):
        from repro_torch.serving import engine

        self.cls, self.inner, self.counters, self.runs = engine.FlowSampler, None, counters, []

    def __enter__(self):
        self.inner = self.cls.sample

        def counted(sampler, *args, **kwargs):
            before = {name: c.launches for name, c in self.counters.items()}
            out = self.inner(sampler, *args, **kwargs)
            self.runs.append({name: c.launches - before[name]
                              for name, c in self.counters.items()})
            return out

        self.cls.sample = counted
        return self

    def __exit__(self, *exc):
        self.cls.sample = self.inner


def baselines_served(dev, counters, card: str) -> dict:
    """Phase 4b: each baseline at NFE 8, built for yi-6b's fm_ot field, saved
    as a baseline ``ns`` artifact and served by serve.main with phase 4's
    flags plus --requests 2 and --solver-artifact: exact launches a request,
    a load and no distillation, the served NSParams equal to the built ones
    to the bit, finite latents."""
    from repro_torch.configs import get_config
    from repro_torch.core.schedulers import get_scheduler
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.solvers import SolverArtifact, SolverSpec

    # the build reads the field's scheduler only: no weights behind this closure
    field = M.velocity_field({}, get_config("yi-6b", smoke=False), get_scheduler("fm_ot"))
    per_request = {**dict.fromkeys(KERNELS, 0), "ns_update": NFE,
                   "flash_attention": LAYERS * NFE}
    out = {"launches": dict.fromkeys(KERNELS, 0), "request_ms": {}}
    for name in BASELINES:
        spec = SolverSpec(name, NFE)
        built = spec.build(field)
        path = ROOT / "build" / "chip_smoke" / f"{name}_nfe{NFE}.msgpack"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.unlink(missing_ok=True)
        SolverArtifact(spec=spec, params=built, val_psnr=float("nan"),
                       provenance={"arch": "yi-6b", "scheduler": "fm_ot"}).save(str(path))
        free_device_memory(dev)
        reset(counters)
        t0 = time.perf_counter()
        with Tee() as text, PerRequest(counters) as runs:
            served = serve.main(["--arch", "yi-6b", "--mode", "flow", "--full",
                                 "--nfe", str(NFE), "--batch", str(BATCH), "--seq", str(SEQ),
                                 "--requests", str(BASELINE_REQUESTS), "--bns-iters", "0",
                                 "--solver-artifact", str(path)])
        wall = time.perf_counter() - t0
        launches = {k: c.launches for k, c in counters.items()}
        same = all(torch.equal(a.cpu(), b) for a, b in zip(served.sampler.solver, built))
        z = served.zoo
        finite = [bool(torch.isfinite(x.latents).all()) and x.latents.shape == (BATCH, SEQ, 64)
                  for x in served]
        a_max, b_max = float(built.a.abs().max()), float(built.b.abs().max())
        print(f"baseline {name} NFE {NFE} served (yi-6b full width, batch {BATCH}, seq "
              f"{SEQ}, {card}): request ms {[round(x.ms, 3) for x in served]}, launches a "
              f"request {runs.runs}, zoo {z}, NSParams equal to the built ones: {same}, "
              f"max |a| {a_max:.4g}, max |b| {b_max:.4g}, main() wall {wall:.3f} s")
        if (runs.runs != [per_request] * BASELINE_REQUESTS
                or launches != {k: v * BASELINE_REQUESTS for k, v in per_request.items()}
                or (z.loads, z.distills) != (1, 0) or "no retraining" not in text.text
                or served.artifact.spec != spec or not same or not all(finite)
                or len(served) != BASELINE_REQUESTS):
            raise SystemExit(f"baseline {name} served wrong: launches {runs.runs} (expected "
                             f"{per_request} a request), zoo {z}, solver equal {same}, "
                             f"finite latents {finite}")
        out["request_ms"][name] = [x.ms for x in served]
        for k in KERNELS:
            out["launches"][k] += launches[k]
    return out


def relative_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(a.cpu() - b) / torch.linalg.vector_norm(b))


def baselines_against_cpu(dev, counters, cfg, params) -> dict:
    """Phase 5b: the new solver paths on the card (kernels) against the CPU
    (plain versions), phase 5's 2-layer f32 model, relative L2 <= 1e-4:
    ddim, dpm2m and edm_heun at NFE 8 under fm_ot and vp, midpoint with
    sigma0 = 2, and a BST-Euler solver at NFE 4 with random knots, run
    directly (no ns_update launch) and through its to_ns parameters sampled
    by ns_sample (the ST ⊂ NS inclusion of Theorem 3.2)."""
    from repro_torch.core import bst_solver, taxonomy
    from repro_torch.core.ns_solver import ns_sample
    from repro_torch.core.schedulers import get_scheduler
    from repro_torch.data.synthetic import DataConfig, SyntheticTokens
    from repro_torch.models import model as M
    from repro_torch.models.transformer import params_to
    from repro_torch.solvers.registry import build_ns

    batch = SyntheticTokens(cfg, DataConfig(batch_size=2, seq_len=128, seed=0),
                            device="cpu").batch(0)
    card_params = params_to(params, dev)
    x0 = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 128, cfg.latent_dim)).astype(np.float32))

    def fields(sname):
        sched = get_scheduler(sname)
        return (M.velocity_field(params, cfg, sched, batch),
                M.velocity_field(card_params, cfg, sched,
                                 {k: v.to(dev) for k, v in batch.items()}))

    total = dict.fromkeys(KERNELS, 0)

    def on_card(fn, want):
        before = {name: c.launches for name, c in counters.items()}
        with torch.no_grad():
            out = fn()
        torch.cuda.synchronize(dev)
        ran = {name: c.launches - before[name] for name, c in counters.items()}
        for name in KERNELS:
            total[name] += ran[name]
        return out, ran == {**dict.fromkeys(KERNELS, 0), **want}, ran

    cases, failed = {}, []
    for sname in ("fm_ot", "vp"):
        cpu_f, card_f = fields(sname)
        runs = [(name, build_ns(name, NFE, cpu_f)) for name in BASELINES]
        if sname == "fm_ot":
            runs.append(("midpoint sigma0=2", build_ns("midpoint", NFE, cpu_f, sigma0=2.0)))
        for name, ns in runs:
            with torch.no_grad():
                ref = ns_sample(ns, cpu_f.fn, x0)
            got, ok, ran = on_card(lambda: ns_sample(ns, card_f.fn, x0.to(dev)),
                                   {"ns_update": NFE, "flash_attention": 2 * NFE})
            key = f"{name} {sname}"
            cases[key] = {"rel_l2": relative_l2(got, ref), "max_abs_a": float(ns.a.abs().max()),
                          "max_abs_b": float(ns.b.abs().max()), "launches_ok": ok}
            if not ok:
                failed.append(f"{key}: launched {ran}")
    cpu_f, card_f = fields("fm_ot")
    rng = np.random.default_rng(17)
    k = bst_solver.knot_positions(4, "euler").shape[0]
    theta = bst_solver.bst_params_from_numpy(*((0.2 * rng.standard_normal(n)).astype(
        np.float32) for n in (k - 1, k, k, k)))
    knots = bst_solver.materialize_bst(theta)
    prog = bst_solver.bst_euler_program
    with torch.no_grad():
        ref = taxonomy.run_direct(prog, cpu_f, x0, knots)
    got, ok, ran = on_card(lambda: taxonomy.run_direct(
        prog, card_f, x0.to(dev), bst_solver.materialize_bst(
            bst_solver.BSTParams(*(p.to(dev) for p in theta)))), {"flash_attention": 2 * 4})
    cases["bst euler run_direct"] = {"rel_l2": relative_l2(got, ref), "launches_ok": ok}
    if not ok:
        failed.append(f"bst run_direct: launched {ran}")
    ns = taxonomy.to_ns(prog, knots)
    got, ok, ran = on_card(lambda: ns_sample(ns, card_f.fn, x0.to(dev)),
                           {"ns_update": 4, "flash_attention": 2 * 4})
    cases["bst euler to_ns, ns_sample"] = {"rel_l2": relative_l2(got, ref), "launches_ok": ok}
    if not ok:
        failed.append(f"bst to_ns: launched {ran}")
    for key, c in cases.items():
        extra = (f", max |a| {c['max_abs_a']:.4g}, max |b| {c['max_abs_b']:.4g}"
                 if "max_abs_a" in c else "")
        print(f"5b {key}, yi-6b 2 layers f32, card vs CPU: relative L2 {c['rel_l2']:.3e} "
              f"(limit 1e-4){extra}")
        if not c["rel_l2"] <= 1e-4:
            failed.append(f"{key}: relative L2 {c['rel_l2']} over 1e-4")
    if failed:
        raise SystemExit("phase 5b: " + "; ".join(failed))
    return {"cases": cases, "launches": total}


class CountCalls:
    """Counts (and optionally records the logits of) ``decode_apply`` calls,
    apart from any kernel's counter, by wrapping the model function the
    engine calls."""

    def __init__(self, keep_logits: bool = False):
        from repro_torch.models import model as M

        self.module, self.inner = M, M.decode_apply
        self.calls, self.keep, self.logits = 0, keep_logits, []

    def __enter__(self):
        def counted(*args, **kwargs):
            logits, state = self.inner(*args, **kwargs)
            self.calls += 1
            if self.keep:
                self.logits.append(logits.float().cpu())
            return logits, state

        self.module.decode_apply = counted
        return self

    def __exit__(self, *exc):
        self.module.decode_apply = self.inner


def decode_path(dev, counters, args: list, per_call: dict):
    """serve.main in decode mode at full width through the gateway: every
    request finishes at its length with in-vocabulary tokens, nothing fails,
    every page returns, and each kernel launches ``per_call[name]`` times a
    ``decode_apply`` call (0 where it is not named)."""
    from repro_torch.launch import serve

    free_device_memory(dev)
    reset(counters)
    with CountCalls() as calls:
        served = serve.main(args)
    launches = {name: c.launches for name, c in counters.items()}
    arch = args[args.index("--arch") + 1]
    n = int(args[args.index("--requests") + 1])
    slots = args[args.index("--max-slots") + 1]
    lengths = [int(x) for x in args[args.index("--decode-lengths") + 1].split(",")]
    s = served.stats
    if len(served.responses) != n or any(r is None for r in served.responses):
        raise SystemExit(f"{arch} decode path: a request was rejected or shed")
    for i, r in enumerate(served.responses):
        toks, want_len = r.tokens.tolist(), lengths[i % len(lengths)]
        if r.meta["finish_reason"] != "length" or len(toks) != want_len:
            raise SystemExit(f"{arch} decode path: {r.meta}, {len(toks)} tokens, "
                             f"expected {want_len}")
        if min(toks) < 0 or max(toks) >= VOCAB[arch]:
            raise SystemExit(f"{arch} decode path: token outside the vocabulary in {toks}")
    if s["failed"] or s.get("pages_in_use", 0) or s["completed"] != n:
        raise SystemExit(f"{arch} decode path: failed {s['failed']}, pages in use "
                         f"{s.get('pages_in_use')}, completed {s['completed']}")
    want = {name: per_call.get(name, 0) * calls.calls for name in KERNELS}
    if launches != want or calls.calls == 0:
        raise SystemExit(f"{arch} decode path launch counts {launches}, expected {want} "
                         f"({calls.calls} decode_apply calls)")
    d = served.metrics["device_dispatch_ms"]
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"decode path: {arch} full width, {n} requests on {slots} slots: "
          f"{s['tokens_out']} tokens in {served.wall_s:.3f} s ({s['tokens_per_s']:.1f} tokens/s "
          f"by the gateway clock), {s['forwards']} engine calls ({s['prefill_calls']} "
          f"prefill, {s['prefill_tokens']} prompt tokens), {calls.calls} decode_apply calls, "
          f"engine call ms mean {d['sum'] / d['count']:.3f} p50 {d['p50']:.3f} "
          f"max {d['max']:.3f}, launches {launches}, peak memory {peak / 2**30:.3f} GiB")
    return launches


def long_row_decode_step(dev, counters) -> dict:
    """Phase 6b: one yi-6b decode step at full width over 8 rows of up to
    4096 positions, through the paged kernel and through the dense gather."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    free_device_memory(dev)
    cfg = get_config("yi-6b")
    params = M.init_params(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    B, ps, nb = len(LONG_LENGTHS), 16, 256
    state = M.init_paged_decode_state(cfg, B, 1 + B * nb, ps, nb, torch.float32, dev)
    g = torch.Generator(device=dev).manual_seed(4)
    table = (torch.randperm(B * nb, generator=g, device=dev) + 1).reshape(B, nb)
    state.block_table.copy_(table.to(torch.int32))
    # random K/V a layer at a time, bf16 values in the f32 pool, as the bf16
    # model's own writes to an f32 slot state are
    for pool in (state.k_pages, state.v_pages):
        for layer in pool:
            layer.copy_(torch.randn(layer.shape, generator=g, device=dev).to(torch.bfloat16))
    state = state._replace(
        index=torch.tensor(LONG_LENGTHS, dtype=torch.int32, device=dev) - 1)
    token = torch.arange(B, dtype=torch.int32, device=dev) * 7 + 3

    def step(p, kernel: bool):
        return M.decode_apply(p, cfg, token, state, paged_kernel=kernel)[0]

    zero = dict.fromkeys(KERNELS, 0)
    with torch.no_grad():
        reset(counters)
        logits = {kernel: step(params, kernel).float() for kernel in (True, False)}
        torch.cuda.synchronize(dev)
        launches = {name: c.launches for name, c in counters.items()}
        if launches != {**zero, "paged_attention": LAYERS}:
            raise SystemExit(f"long-row decode step launched {launches} for one kernel "
                             f"call and one dense call, expected {LAYERS} paged")
        kernel_ms = time_ms(lambda: step(params, True), iters=5, warmup=2)
        dense_ms = time_ms(lambda: step(params, False), iters=5, warmup=2)
        kernel_dev = device_ms(lambda: step(params, True), "paged_attention", iters=3)
        all_dev = device_ms(lambda: step(params, True), None, iters=3)
        rel16 = float(torch.linalg.vector_norm(logits[True] - logits[False])
                      / torch.linalg.vector_norm(logits[False]))
        params = _to_f32(params)                         # the f32 copy replaces it
        torch.cuda.empty_cache()
        logits32 = {kernel: step(params, kernel).float() for kernel in (True, False)}
    rel32 = float(torch.linalg.vector_norm(logits32[True] - logits32[False])
                  / torch.linalg.vector_norm(logits32[False]))
    same = bool(torch.equal(logits32[True].argmax(-1), logits32[False].argmax(-1)))
    peak = torch.cuda.max_memory_allocated(dev)
    kd = "not measured" if kernel_dev is None else f"{kernel_dev:.4f} ms"
    ad = "not measured" if all_dev is None else f"{all_dev:.3f} ms"
    print(f"long-row decode step: yi-6b full width, {B} rows of up to "
          f"{max(LONG_LENGTHS)} positions (f32 pages, {2 * state.k_pages.numel() * 4 / 1e9:.2f} GB): "
          f"decode_apply with the paged kernel {kernel_ms:.3f} ms, with the dense gather "
          f"{dense_ms:.3f} ms; paged kernel device time {kd} a call ({LAYERS} launches), "
          f"all kernels' device time {ad} a call; logits kernel vs dense relative L2 "
          f"{rel16:.3e} with bf16 weights (the dense gather rounds scores and weights "
          f"to bf16), {rel32:.3e} with the f32 copy (limit 1e-4), greedy tokens equal "
          f"(f32): {same}; peak memory {peak / 2**30:.3f} GiB")
    if not (rel32 <= 1e-4 and same):
        raise SystemExit(f"long-row decode step: kernel vs dense gather on the f32 weights: "
                         f"relative L2 {rel32}, same tokens {same}")
    del params, state, logits, logits32
    free_device_memory(dev)
    return {"kernel_path_ms": kernel_ms, "dense_gather_ms": dense_ms,
            "kernel_device_ms": kernel_dev, "all_kernels_device_ms": all_dev}


def _to_f32(tree):
    """The parameter tree with every floating tensor in f32."""
    if isinstance(tree, dict):
        return {k: _to_f32(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_f32(v) for v in tree)
    return tree.float() if torch.is_floating_point(tree) else tree


def decode_against_cpu(dev, counters, cfg, params, engine_kw: dict, per_call: dict):
    """The same gateway requests on the card and on the CPU: every step's
    logits within relative L2 1e-4 and the same greedy tokens; on the card
    each kernel launches ``per_call[name]`` times a ``decode_apply`` call."""
    from repro_torch.models.transformer import params_to
    from repro_torch.serving.decode import DecodeGateway, DecodeRequest
    from repro_torch.serving.engine import DecodeEngine

    def serve_on(p):
        engine = DecodeEngine(params=p, cfg=cfg, **engine_kw)
        gw = DecodeGateway(engine, max_slots=2, cache_slots=32, prefill_chunk=4)
        futures = [gw.submit(DecodeRequest(prompt=[(3 * r + 1) % cfg.vocab,
                                                   (5 * r + 2) % cfg.vocab],
                                           max_tokens=n))
                   for r, n in enumerate([6, 3, 5, 2])]
        with CountCalls(keep_logits=True) as rec:
            while not all(f.done() for f in futures):
                gw.pump()
        return [f.result().tokens.tolist() for f in futures], rec.logits

    before = {name: c.launches for name, c in counters.items()}
    card_tokens, card_logits = serve_on(params_to(params, dev))
    ran = {name: c.launches - before[name] for name, c in counters.items()}
    want = {name: per_call.get(name, 0) * len(card_logits) for name in KERNELS}
    if ran != want:
        raise SystemExit(f"{cfg.name} decode card run launched {ran} for "
                         f"{len(card_logits)} decode_apply calls, expected {want}")
    cpu_tokens, cpu_logits = serve_on(params)
    rels = [float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))
            for a, b in zip(card_logits, cpu_logits)]
    print(f"decode path, {cfg.name}, card vs CPU plain (2 layers, f32, 4 requests): "
          f"{len(rels)} steps, worst logits relative L2 {max(rels):.3e} (limit 1e-4), "
          f"tokens equal: {card_tokens == cpu_tokens}")
    if len(card_logits) != len(cpu_logits) or not max(rels) <= 1e-4:
        raise SystemExit(f"{cfg.name} decode path: per-step logits relative L2 {rels}")
    if card_tokens != cpu_tokens:
        top2 = [torch.topk(lg, 2, dim=-1).values for lg in cpu_logits]
        margin = min(float((t[:, 0] - t[:, 1]).min()) for t in top2)
        raise SystemExit(f"{cfg.name} decode path: tokens differ ({card_tokens} vs "
                         f"{cpu_tokens}); smallest top-2 logit margin on the CPU "
                         f"{margin:.3e}")


class Tee:
    """Copies what is printed to stdout into ``text`` while it still goes out."""

    def __enter__(self):
        self.out, self.parts = sys.stdout, []
        sys.stdout = self
        return self

    def write(self, data):
        self.parts.append(data)
        return self.out.write(data)

    def flush(self):
        self.out.flush()

    def __exit__(self, *exc):
        sys.stdout = self.out

    @property
    def text(self) -> str:
        return "".join(self.parts)


def distill_args() -> list:
    """Phase 12's (and 12b's) flags."""
    return ["--arch", "yi-6b", "--mode", "flow", "--full", "--nfe", str(NFE),
            "--batch", str(BATCH), "--seq", str(SEQ), "--bns-iters", str(DISTILL_ITERS),
            "--requests", str(DISTILL_REQUESTS), "--solver-artifact", str(BNS_ARTIFACT)]


def distill_path(dev, counters) -> dict:
    """Phase 12: serve.main distils a BNS solver for yi-6b at full width,
    saves it as an artifact and serves the reloaded copy; launch counts as
    the module docstring states them."""
    from repro_torch.launch import serve

    BNS_ARTIFACT.unlink(missing_ok=True)
    free_device_memory(dev)
    reset(counters)
    t0 = time.perf_counter()
    served = serve.main(distill_args())
    wall = time.perf_counter() - t0
    d = served.distillation
    K, R = DISTILL_ITERS, sum(d.rk45[part][0] for part in ("train", "val"))
    no_grad_calls = R + NFE + NFE + DISTILL_REQUESTS * NFE
    want = {**dict.fromkeys(KERNELS, 0),
            "flash_attention": LAYERS * (no_grad_calls + 2 * NFE * K),
            "flash_attention_bwd": LAYERS * NFE * K,
            "ns_update": NFE * (2 + DISTILL_REQUESTS + K), "ns_update_bwd": NFE * K}
    launches = {name: c.launches for name, c in counters.items()}
    if launches != want:
        raise SystemExit(f"distillation launch counts {launches}, expected {want} "
                         f"(RK45 evaluations {R})")
    z, art = served.zoo, served.artifact
    saved_as_trained = all(torch.equal(a.cpu(), b.cpu())   # the artifact loads on the CPU
                           for a, b in zip(art.params, d.params))
    if ((z.distills, z.loads, art.kind) != (1, 0, "bns") or not BNS_ARTIFACT.exists()
            or not saved_as_trained):
        raise SystemExit(f"distillation: zoo {z}, kind {art.kind}, artifact saved "
                         f"{BNS_ARTIFACT.exists()}, its BNSParams equal to the distilled "
                         f"ones: {saved_as_trained}")
    losses = [h[1] for h in d.history]
    if not (d.history and all(np.isfinite(losses)) and np.isfinite(d.val_psnr)
            and np.isfinite(d.init_val_psnr)):
        raise SystemExit(f"distillation: non-finite loss or PSNR: {d.history}, "
                         f"init {d.init_val_psnr}")
    if not d.val_psnr >= d.init_val_psnr:
        raise SystemExit(f"distillation: val PSNR {d.val_psnr} below the initial "
                         f"solver's {d.init_val_psnr}")
    for s in served:
        if s.latents.shape != (BATCH, SEQ, 64) or not bool(torch.isfinite(s.latents).all()):
            raise SystemExit(f"distilled solver: bad latents {tuple(s.latents.shape)}")
    peak = torch.cuda.max_memory_allocated(dev)
    # train_bns' wall holds K iterations and one validation, which costs what
    # the initial solver's validation did
    iter_ms = (d.train_seconds - d.init_val_seconds) / K * 1e3
    print(f"distillation: yi-6b full width, NFE {NFE}, batch {BATCH}, seq {SEQ}: RK45 "
          f"train nfe/accepted/rejected {d.rk45['train']}, val {d.rk45['val']} "
          f"({d.rk45_seconds:.3f} s); val PSNR initial {d.init_val_psnr:.4f} dB -> distilled "
          f"{d.val_psnr:.4f} dB after {K} iterations (losses {[round(x, 5) for x in losses]}); "
          f"train_bns {d.train_seconds:.3f} s, ~{iter_ms:.1f} ms an iteration (one "
          f"validation {d.init_val_seconds * 1e3:.1f} ms taken off; each, the last with "
          f"its validation, {[round(x * 1e3, 1) for x in d.iteration_seconds]}); artifact "
          f"saved and reloaded (its BNSParams equal to the distilled ones to the bit), zoo "
          f"{z}; request ms with the "
          f"distilled solver {[round(x.ms, 3) for x in served]}; launches {launches}; peak "
          f"memory {peak / 2**30:.3f} GiB; main() wall {wall:.3f} s")
    return {"rk45": d.rk45, "rk45_s": d.rk45_seconds, "init_val_psnr": d.init_val_psnr,
            "val_psnr": d.val_psnr, "iterations": K, "iteration_ms": iter_ms,
            "request_ms": [x.ms for x in served], "peak_gib": peak / 2**30,
            "launches": launches, "wall_s": wall,
            "each_iteration_ms": [x * 1e3 for x in d.iteration_seconds],
            "solver": [t.cpu() for t in served.sampler.solver],
            "latents": [x.latents.cpu() for x in served]}


def artifact_reload(dev, counters, distilled: dict) -> dict:
    """Phase 12b: phase 12's flags in a fresh serve.main call load the saved
    artifact: no retraining, exact launch counts, solver and latents equal
    to phase 12's to the bit."""
    from repro_torch.launch import serve

    free_device_memory(dev)
    reset(counters)
    t0 = time.perf_counter()
    with Tee() as out:
        served = serve.main(distill_args())
    wall = time.perf_counter() - t0
    launches = {name: c.launches for name, c in counters.items()}
    want = {**dict.fromkeys(KERNELS, 0), "flash_attention": LAYERS * NFE * DISTILL_REQUESTS,
            "ns_update": NFE * DISTILL_REQUESTS}
    if launches != want:
        raise SystemExit(f"artifact reload launch counts {launches}, expected {want}")
    z = served.zoo
    if "no retraining" not in out.text or (z.loads, z.distills) != (1, 0) \
            or served.distillation is not None:
        raise SystemExit(f"artifact reload: zoo {z}, distillation {served.distillation}, "
                         f"'no retraining' printed: {'no retraining' in out.text}")
    solver = [t.cpu() for t in served.sampler.solver]
    same_solver = all(torch.equal(a, b) for a, b in zip(solver, distilled["solver"]))
    same_latents = [torch.equal(s.latents.cpu(), ref)
                    for s, ref in zip(served, distilled["latents"])]
    diff = [float((s.latents.cpu() - ref).abs().max())
            for s, ref in zip(served, distilled["latents"])]
    print(f"artifact reload: zoo {z}; launches {launches}; request ms "
          f"{[round(x.ms, 3) for x in served]}; NSParams equal to phase 12's: {same_solver}; "
          f"latents equal to phase 12's: {same_latents} (max |diff| {diff}); "
          f"main() wall {wall:.3f} s")
    if not (same_solver and all(same_latents) and len(same_latents) == DISTILL_REQUESTS):
        raise SystemExit("artifact reload: the served solver or latents differ from phase 12's")
    return {"launches": launches, "request_ms": [x.ms for x in served], "wall_s": wall}


def anytime_path(dev, counters) -> dict:
    """Phase 12c: serve.main distils an anytime solver over budgets (4, 8)
    for yi-6b at full width, saves and reloads it and routes 3 requests;
    launch counts as the module docstring states them; then the served
    sampler's exits against per-budget sampling and carry legs, to the bit."""
    from repro_torch.data.synthetic import DataConfig, SyntheticTokens
    from repro_torch.launch import serve
    from repro_torch.serving import nearest_budget

    ANYTIME_ARTIFACT.unlink(missing_ok=True)
    free_device_memory(dev)
    reset(counters)
    t0 = time.perf_counter()
    with Tee() as out:
        served = serve.main(["--arch", "yi-6b", "--mode", "flow", "--full",
                             "--budgets", ",".join(map(str, ANYTIME_BUDGETS)),
                             "--request-budgets", ",".join(map(str, ANYTIME_REQUEST_BUDGETS)),
                             "--batch", str(BATCH), "--seq", str(ANYTIME_SEQ),
                             "--bns-iters", str(ANYTIME_ITERS),
                             "--requests", str(len(ANYTIME_REQUEST_BUDGETS)),
                             "--solver-artifact", str(ANYTIME_ARTIFACT)])
    wall = time.perf_counter() - t0
    launches = {name: c.launches for name, c in counters.items()}
    d = served.distillation
    K, R = ANYTIME_ITERS, sum(d.rk45[part][0] for part in ("train", "val"))
    top = ANYTIME_BUDGETS[-1]
    rules = top + len(ANYTIME_BUDGETS) - 1            # intermediate rules + exits
    served_nfe = [nearest_budget(ANYTIME_BUDGETS, m) for m in ANYTIME_REQUEST_BUDGETS]
    want = {**dict.fromkeys(KERNELS, 0),
            "flash_attention": LAYERS * (R + 2 * top + sum(served_nfe) + 2 * top * K),
            "flash_attention_bwd": LAYERS * top * K,
            "ns_update": 2 * rules + sum(served_nfe) + rules * K, "ns_update_bwd": rules * K}
    if launches != want:
        raise SystemExit(f"anytime launch counts {launches}, expected {want} "
                         f"(RK45 evaluations {R})")
    warnings = out.text.count("WARNING: requested NFE 16 not served")
    losses = [h[1] for h in d.history]
    if (warnings != 1 or [s.nfe for s in served] != served_nfe
            or (served.zoo.distills, served.artifact.kind, served.artifact.budgets)
            != (1, "anytime", ANYTIME_BUDGETS)
            or not (d.history and all(np.isfinite(losses)) and np.isfinite(d.val_psnr)
                    and np.isfinite(d.init_val_psnr))):
        raise SystemExit(f"anytime: {warnings} nearest-budget warnings, served NFE "
                         f"{[s.nfe for s in served]}, zoo {served.zoo}, kind "
                         f"{served.artifact.kind}, "
                         f"history {d.history}, init PSNR {d.init_val_psnr}")
    for s in served:
        if s.latents.shape != (BATCH, ANYTIME_SEQ, 64) or not bool(
                torch.isfinite(s.latents).all()):
            raise SystemExit(f"anytime: bad latents {tuple(s.latents.shape)}")
    peak = torch.cuda.max_memory_allocated(dev)
    iter_ms = (d.train_seconds - d.init_val_seconds) / K * 1e3
    # the exits on one seeded x0, to the bit
    sampler = served.sampler
    cond = SyntheticTokens(sampler.cfg, DataConfig(batch_size=BATCH, seq_len=ANYTIME_SEQ,
                                                   seed=0), device=dev).batch(0)
    x0 = torch.randn((BATCH, ANYTIME_SEQ, sampler.cfg.latent_dim), device=dev,
                     generator=torch.Generator(device=dev).manual_seed(12))
    every = sampler.sample_all_from(cond, x0)
    carry, exits = sampler.carry_start(cond, x0), {}
    for stop in ANYTIME_BUDGETS:
        carry, e = sampler.carry_extend(cond, carry, stop)
        exits.update(e)
    checks = {}
    for m in ANYTIME_BUDGETS:
        checks[f"sample_all_from[{m}] == sample_from({m})"] = torch.equal(
            every[m], sampler.sample_from(cond, x0, m))
        checks[f"carry legs [{m}] == sample_all_from[{m}]"] = torch.equal(exits[m], every[m])
    print(f"anytime: yi-6b full width, budgets {ANYTIME_BUDGETS}, batch {BATCH}, seq "
          f"{ANYTIME_SEQ}: RK45 train {d.rk45['train']}, val {d.rk45['val']} "
          f"({d.rk45_seconds:.3f} s); mean val PSNR initial {d.init_val_psnr:.4f} dB -> "
          f"distilled {d.val_psnr:.4f} dB after {K} iterations (losses "
          f"{[round(x, 5) for x in losses]}); train_anytime {d.train_seconds:.3f} s, "
          f"~{iter_ms:.1f} ms an iteration (one validation {d.init_val_seconds * 1e3:.1f} ms "
          f"taken off; each, the last with its validation, "
          f"{[round(x * 1e3, 1) for x in d.iteration_seconds]}); requests "
          f"{list(ANYTIME_REQUEST_BUDGETS)} served at {served_nfe} NFE "
          f"in {[round(x.ms, 3) for x in served]} ms; nearest-budget warnings {warnings}; "
          f"zoo {served.zoo}; launches {launches}; peak memory {peak / 2**30:.3f} GiB; "
          f"main() wall {wall:.3f} s; to the bit: {checks}")
    if not all(checks.values()):
        raise SystemExit(f"anytime: exits differ: {checks}")
    return {"rk45": d.rk45, "rk45_s": d.rk45_seconds, "init_val_psnr": d.init_val_psnr,
            "val_psnr": d.val_psnr, "iterations": K, "iteration_ms": iter_ms,
            "each_iteration_ms": [x * 1e3 for x in d.iteration_seconds],
            "request_ms": [x.ms for x in served], "request_nfe": served_nfe,
            "peak_gib": peak / 2**30, "launches": launches, "wall_s": wall}


def bst_distill_path(dev, counters) -> dict:
    """Phase 12d: a BST-Euler solver distilled at yi-6b's full width: the
    launcher's field (each layer recomputed in the backward), one
    generate_pairs call of BST_PAIRS samples at seq BST_SEQ (one RK45 solve
    over a conditioning batch of BATCH rows taken twice, so train rows 0..3
    and val rows 4..7 share it), then SolverSpec("euler", 8, mode="bst")
    .distill for BST_ITERS full-batch iterations; launch counts exact per
    stage, the BST claim (val PSNR >= Euler's - 0.2 dB), the artifact saved
    and reloaded bit-equal, and its ns_params refused with TypeError."""
    from repro_torch.configs import get_config
    from repro_torch.core import bns, bst_solver
    from repro_torch.core.parametrization import VelocityField
    from repro_torch.core.schedulers import get_scheduler
    from repro_torch.data.synthetic import DataConfig, SyntheticTokens
    from repro_torch.models import model as M
    from repro_torch.solvers import SolverArtifact, SolverSpec

    BST_ARTIFACT.unlink(missing_ok=True)
    free_device_memory(dev)
    t_phase = time.perf_counter()
    cfg = get_config("yi-6b", smoke=False)
    params = M.init_params(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    cond = SyntheticTokens(cfg, DataConfig(batch_size=BATCH, seq_len=BST_SEQ, seed=0),
                           device=dev).batch(0)
    sched = get_scheduler("fm_ot")
    field = M.velocity_field(params, cfg, sched, cond, remat=True)
    twice = M.velocity_field(params, cfg, sched,
                             {k: torch.cat([v, v]) for k, v in cond.items()})
    calls = [0]

    def counted(t, x):
        calls[0] += 1
        return twice.fn(t, x)

    stages, zero = {}, dict.fromkeys(KERNELS, 0)

    def stage(name, fn, want_of):
        reset(counters)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize(dev)
        ms = (time.perf_counter() - t0) * 1e3
        launches = {k: c.launches for k, c in counters.items()}
        want = {**zero, **want_of()}
        stages[name] = {"launches": launches, "ms": ms}
        if launches != want:
            raise SystemExit(f"BST {name}: launched {launches}, expected {want}")
        return out

    x0, x1 = stage("rk45", lambda: bns.generate_pairs(
        VelocityField(fn=counted, scheduler=sched),
        torch.Generator(device=dev).manual_seed(1), BST_PAIRS, (BST_SEQ, cfg.latent_dim)),
        lambda: {"flash_attention": LAYERS * calls[0]})
    train, val = (x0[:BATCH], x1[:BATCH]), (x0[BATCH:], x1[BATCH:])
    euler = stage("euler init", lambda: SolverSpec("euler", NFE).sampler(field).psnr(val),
                  lambda: {"ns_update": NFE, "flash_attention": LAYERS * NFE})
    K = BST_ITERS
    spec = SolverSpec("euler", NFE, mode="bst")
    res = stage("training", lambda: spec.distill(
        field, train, val, bns.BNSTrainConfig(lr=1e-3, lr_schedule="cosine", iterations=K,
                                              val_every=100, batch_size=BATCH)),
        lambda: {"flash_attention": LAYERS * (2 * NFE * K + NFE),
                 "flash_attention_bwd": LAYERS * NFE * K})
    peak = torch.cuda.max_memory_allocated(dev)
    reset(counters)
    res.artifact(provenance={"arch": "yi-6b", "scheduler": "fm_ot"}).save(str(BST_ARTIFACT))
    back = SolverArtifact.load(str(BST_ARTIFACT))
    same = all(torch.equal(a.cpu(), b) for a, b in zip(res.params, back.params))
    try:
        back.ns_params
        refused = False
    except TypeError:
        refused = True
    moved = not all(torch.equal(p.cpu(), q)
                    for p, q in zip(res.params, bst_solver.identity_bst(NFE, "euler")))
    losses = [h[1] for h in res.history]
    iteration_ms = [x * 1e3 for x in res.iteration_seconds]
    print(f"BST distillation: yi-6b full width, euler NFE {NFE}, {BST_PAIRS} pairs at seq "
          f"{BST_SEQ} ({calls[0]} RK45 evaluations, {stages['rk45']['ms'] / 1e3:.3f} s), "
          f"{BATCH} train / {BATCH} val: val PSNR Euler {euler:.4f} dB -> BST "
          f"{res.val_psnr:.4f} dB after {K} iterations, knots moved off the identity: "
          f"{moved} (losses "
          f"{[round(x, 5) for x in losses]}); ms an iteration (bns.fit's, the last with its "
          f"validation) {[round(x, 1) for x in iteration_ms]}; launches by stage "
          f"{ {k: v['launches'] for k, v in stages.items()} }; artifact {back.kind} reloaded "
          f"bit-equal: {same}, ns_params refused: {refused}; peak memory "
          f"{peak / 2**30:.3f} GiB; phase wall {time.perf_counter() - t_phase:.3f} s")
    if not (np.isfinite(res.val_psnr) and all(np.isfinite(losses)) and losses):
        raise SystemExit(f"BST distillation: non-finite loss or PSNR {res.history}")
    if not (res.val_psnr >= euler - 0.2 and res.val_psnr > euler and moved):
        raise SystemExit(f"BST distillation learned nothing: val PSNR {res.val_psnr} against "
                         f"Euler's {euler}, knots moved off the identity: {moved}")
    if not (same and refused and back.kind == "bst"):
        raise SystemExit(f"BST artifact: reloaded equal {same}, kind {back.kind}, "
                         f"ns_params refused {refused}")
    launches = {k: sum(v["launches"][k] for v in stages.values()) for k in KERNELS}
    return {"launches": launches, "training_launches": stages["training"]["launches"],
            "rk45_evaluations": calls[0], "rk45_s": stages["rk45"]["ms"] / 1e3,
            "euler_val_psnr": euler, "val_psnr": res.val_psnr, "iterations": K,
            "each_iteration_ms": iteration_ms, "peak_gib": peak / 2**30}


def gradient_against_cpu(dev, counters, cfg, params) -> None:
    """Phase 13: _loss_fn and its gradient in theta on the card (kernels)
    against the CPU (plain versions), then theta after a few train_solver
    steps; limits as the module docstring states them."""
    from repro_torch.core import bns, ns_solver
    from repro_torch.core.schedulers import get_scheduler
    from repro_torch.data.synthetic import DataConfig, SyntheticTokens
    from repro_torch.models import model as M
    from repro_torch.models.transformer import params_to
    from repro_torch.solvers.registry import build_ns

    batch = SyntheticTokens(cfg, DataConfig(batch_size=2, seq_len=128, seed=0),
                            device="cpu").batch(0)
    rng = np.random.default_rng(13)
    x0, x1 = (torch.from_numpy(rng.standard_normal((2, 128, cfg.latent_dim))
                               .astype(np.float32)) for _ in "01")
    theta0 = ns_solver.from_ns(build_ns("euler", 4, None))
    fields = {"cpu": M.velocity_field(params, cfg, get_scheduler("fm_ot"), batch, remat=True),
              "card": M.velocity_field(params_to(params, dev), cfg, get_scheduler("fm_ot"),
                                       {k: v.to(dev) for k, v in batch.items()}, remat=True)}
    got = {}
    for where, field in fields.items():
        d = dev if where == "card" else torch.device("cpu")
        th = ns_solver.BNSParams(*(p.to(d).requires_grad_(True) for p in theta0))
        before = {name: c.launches for name, c in counters.items()}
        loss = bns._loss_fn(bns.ns_sampler(field), th, x0.to(d), x1.to(d))
        grads = torch.autograd.grad(loss, list(th))
        ran = {name: c.launches - before[name] for name, c in counters.items()}
        want = ({**dict.fromkeys(KERNELS, 0), "flash_attention": 2 * 4 * 2,
                 "flash_attention_bwd": 2 * 4, "ns_update": 4, "ns_update_bwd": 4}
                if where == "card" else dict.fromkeys(KERNELS, 0))
        if ran != want:
            raise SystemExit(f"gradient on the {where}: launched {ran}, expected {want}")
        got[where] = (loss.detach().cpu(), [g.cpu() for g in grads])
    rels = [float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b).clamp_min(1e-30))
            for a, b in zip([got["card"][0], *got["card"][1]], [got["cpu"][0], *got["cpu"][1]])]
    print(f"gradient, yi-6b 2 layers f32, euler NFE 4, remat: card vs CPU relative L2 of "
          f"loss {rels[0]:.3e}, d/d time_logits {rels[1]:.3e}, d/da {rels[2]:.3e}, "
          f"d/db {rels[3]:.3e} (limit 1e-4)")
    if not max(rels) <= 1e-4:
        raise SystemExit(f"gradient card vs CPU: relative L2 {rels} over 1e-4")
    cfg_t = bns.BNSTrainConfig(nfe=4, init_solver="euler", lr=DISTILL_CHECK_LR,
                               lr_schedule="cosine", iterations=DISTILL_CHECK_STEPS,
                               val_every=100, batch_size=2)
    thetas = {}
    for where, field in fields.items():
        d = dev if where == "card" else torch.device("cpu")
        res = bns.train_solver(bns.ns_sampler(field), theta0, (x0.to(d), x1.to(d)),
                               (x0.to(d), x1.to(d)), cfg_t)
        thetas[where] = torch.cat([p.cpu().reshape(-1) for p in res.params])
    g0 = torch.cat([g.reshape(-1) for g in got["cpu"][1]]).abs()
    signed = g0 >= 1e-3 * g0.max()
    diff = (thetas["card"] - thetas["cpu"]).abs()
    step = DISTILL_CHECK_LR * DISTILL_CHECK_STEPS
    r_signed = float((diff[signed] / (1e-3 * step)).max())
    r_rest = float((diff[~signed] / (2 * step)).max()) if bool((~signed).any()) else 0.0
    print(f"theta after {DISTILL_CHECK_STEPS} train_solver steps (lr {DISTILL_CHECK_LR}), card "
          f"vs CPU: {int(signed.sum())} components with a clear gradient sign at "
          f"{r_signed:.4f} of their limit (1e-3 of lr a step), {int((~signed).sum())} others at "
          f"{r_rest:.4f} of theirs (2 lr a step); largest difference {float(diff.max()):.3e}")
    if not (r_signed <= 1 and r_rest <= 1):
        raise SystemExit(f"theta card vs CPU outside its limits: {r_signed}, {r_rest}")


def anytime_gradient_against_cpu(dev, counters, cfg, params) -> dict:
    """Phase 13b: anytime_loss and its gradient in every field of
    AnytimeParams on the card (kernels) against the CPU (plain versions);
    limits as the module docstring states them."""
    from repro_torch.core import anytime
    from repro_torch.core.schedulers import get_scheduler
    from repro_torch.data.synthetic import DataConfig, SyntheticTokens
    from repro_torch.models import model as M
    from repro_torch.models.transformer import params_to

    budgets = (2, 4)
    batch = SyntheticTokens(cfg, DataConfig(batch_size=2, seq_len=128, seed=0),
                            device="cpu").batch(0)
    rng = np.random.default_rng(14)
    x0, x1 = (torch.from_numpy(rng.standard_normal((2, 128, cfg.latent_dim))
                               .astype(np.float32)) for _ in "01")
    theta0 = anytime.AnytimeParams(*(
        p + torch.from_numpy(0.1 * rng.standard_normal(tuple(p.shape)).astype(np.float32))
        for p in anytime.init_anytime(None, budgets)))
    fields = {"cpu": M.velocity_field(params, cfg, get_scheduler("fm_ot"), batch, remat=True),
              "card": M.velocity_field(params_to(params, dev), cfg, get_scheduler("fm_ot"),
                                       {k: v.to(dev) for k, v in batch.items()}, remat=True)}
    rules = budgets[-1] + len(budgets) - 1
    got, launched = {}, {}
    for where, field in fields.items():
        d = dev if where == "card" else torch.device("cpu")
        th = anytime.AnytimeParams(*(p.to(d).requires_grad_(True) for p in theta0))
        before = {name: c.launches for name, c in counters.items()}
        loss = anytime.anytime_loss(th, budgets, field.fn, x0.to(d), x1.to(d))
        grads = torch.autograd.grad(loss, list(th))
        ran = {name: c.launches - before[name] for name, c in counters.items()}
        want = ({**dict.fromkeys(KERNELS, 0), "flash_attention": 2 * 4 * 2,
                 "flash_attention_bwd": 2 * 4, "ns_update": rules, "ns_update_bwd": rules}
                if where == "card" else dict.fromkeys(KERNELS, 0))
        if ran != want:
            raise SystemExit(f"anytime gradient on the {where}: launched {ran}, expected {want}")
        launched[where] = ran
        got[where] = [loss.detach().cpu(), *(g.cpu() for g in grads)]
    rels = [float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b).clamp_min(1e-30))
            for a, b in zip(got["card"], got["cpu"])]
    names = ["loss"] + [f"d/d {f}" for f in anytime.AnytimeParams._fields]
    print(f"anytime gradient, yi-6b 2 layers f32, budgets {budgets}, remat: card vs CPU "
          f"relative L2 " + ", ".join(f"{n} {r:.3e}" for n, r in zip(names, rels))
          + f" (limit 1e-4); card launches {launched['card']}")
    if not max(rels) <= 1e-4:
        raise SystemExit(f"anytime gradient card vs CPU: relative L2 {rels} over 1e-4")
    return {"launches": launched["card"], "relative_l2": dict(zip(names, rels))}


def bst_gradient_against_cpu(dev, counters, cfg, params) -> dict:
    """Phase 13c: _loss_fn through bst_sampler and its gradient in every
    field of BSTParams on the card (kernels) against the CPU (plain
    versions); limits as the module docstring states them."""
    from repro_torch.core import bns, bst_solver
    from repro_torch.core.schedulers import get_scheduler
    from repro_torch.data.synthetic import DataConfig, SyntheticTokens
    from repro_torch.models import model as M
    from repro_torch.models.transformer import params_to

    batch = SyntheticTokens(cfg, DataConfig(batch_size=2, seq_len=128, seed=0),
                            device="cpu").batch(0)
    rng = np.random.default_rng(15)
    x0, x1 = (torch.from_numpy(rng.standard_normal((2, 128, cfg.latent_dim))
                               .astype(np.float32)) for _ in "01")
    theta0 = bst_solver.BSTParams(*(
        p + torch.from_numpy(0.1 * rng.standard_normal(tuple(p.shape)).astype(np.float32))
        for p in bst_solver.identity_bst(4, "euler")))
    fields = {"cpu": M.velocity_field(params, cfg, get_scheduler("fm_ot"), batch, remat=True),
              "card": M.velocity_field(params_to(params, dev), cfg, get_scheduler("fm_ot"),
                                       {k: v.to(dev) for k, v in batch.items()}, remat=True)}
    got, launched = {}, {}
    for where, field in fields.items():
        d = dev if where == "card" else torch.device("cpu")
        th = bst_solver.BSTParams(*(p.to(d).requires_grad_(True) for p in theta0))
        before = {name: c.launches for name, c in counters.items()}
        loss = bns._loss_fn(bns.bst_sampler(field), th, x0.to(d), x1.to(d))
        grads = torch.autograd.grad(loss, list(th))
        ran = {name: c.launches - before[name] for name, c in counters.items()}
        want = ({**dict.fromkeys(KERNELS, 0), "flash_attention": 2 * 4 * 2,
                 "flash_attention_bwd": 2 * 4}
                if where == "card" else dict.fromkeys(KERNELS, 0))
        if ran != want:
            raise SystemExit(f"BST gradient on the {where}: launched {ran}, expected {want}")
        launched[where] = ran
        got[where] = [loss.detach().cpu(), *(g.cpu() for g in grads)]
    rels = [float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b).clamp_min(1e-30))
            for a, b in zip(got["card"], got["cpu"])]
    names = ["loss"] + [f"d/d {f}" for f in bst_solver.BSTParams._fields]
    print(f"BST gradient, yi-6b 2 layers f32, euler NFE 4, remat: card vs CPU relative L2 "
          + ", ".join(f"{n} {r:.3e}" for n, r in zip(names, rels))
          + f" (limit 1e-4); card launches {launched['card']}")
    if not max(rels) <= 1e-4:
        raise SystemExit(f"BST gradient card vs CPU: relative L2 {rels} over 1e-4")
    return {"launches": launched["card"], "relative_l2": dict(zip(names, rels))}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import paged_attention as pa
    from repro_torch.kernels.gla_scan import gla_scan as gs
    from repro_torch.kernels.ns_update import ns_update as nu

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True).stdout.strip()
    print(card)
    print(f"msgpack {'.'.join(map(str, msgpack.version))}, "
          f"torch {torch.__version__} (CUDA {torch.version.cuda}), "
          f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")

    t0 = time.perf_counter()
    seconds = build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"({', '.join(f'{k} {v:.1f} s' for k, v in seconds.items()) or 'cached'})")
    for name in build.SOURCES:
        print(ptxas_summary(name, build.library_path(name).with_suffix(".so.log")))

    rows = {"ns_update": ns_update_cases(dev), "flash_attention": flash_cases(dev),
            "paged_attention": paged_cases(dev), "gla_scan": gla_cases(dev),
            "ns_update_bwd": ns_update_bwd_cases(dev),
            "flash_attention_bwd": flash_bwd_cases(dev)}
    for name, cases in rows.items():
        for r in cases:
            lib = ("none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms")
            extra = (f", dense SDPA (gather excluded) {r['yardstick_ms']:.4f} ms, "
                     f"limit ratio {r['limit_ratio']:.4f}" if "yardstick_ms" in r else "")
            if "bound_f32" in r and r["bound_f32"][0] != r["bound_ms"]:
                extra += (f", bound at the f32 CUDA-core peak {r['bound_f32'][0]:.4f} ms "
                          f"({r['bound_f32'][1]})")
            if "tflops" in r:
                extra += (f", {r['tflops']:.1f} TFLOP/s, kernel/bound "
                          f"{r['ms'] / r['bound_ms']:.2f}")
            for key, what in (("dot_limit_ratio", "da, dw at"), ("lse_limit_ratio", "lse at")):
                if key in r:
                    extra += f", {what} {r[key]:.4f} of the limit"
            if name == "flash_attention_bwd":
                passes = ", ".join(f"{k[10:]} {'-' if t is None else f'{t:.4f} ms'}"
                                   for k, t in r["pass_device_ms"].items())
                extra += (f", executed {r['executed_tflops']:.1f} TFLOP/s, device time a "
                          f"pass: {passes}")
                extra += (f", bf16 limit ratio {r['limit_ratio']:.4f}" if "bfloat16" in r["shape"]
                          else "") + " (library: torch autograd of SDPA's backward)"
            for key, what in (("device_ms", "kernel"), ("library_device_ms", "addmv")):
                if key in r:
                    t = "not measured" if r[key] is None else f"{r[key]:.4f} ms"
                    extra += f", {what} device time {t}"
            print(f"{name} [{r['shape']}]: err {r['max_abs_err']:.3e}, "
                  f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                  f"library {lib}, bound {r['bound_ms']:.4f} ms ({r['bound_by']}){extra}")

    counters = {"ns_update": nu.COUNTER, "flash_attention": fa.COUNTER,
                "paged_attention": pa.COUNTER, "gla_scan": gs.COUNTER,
                "ns_update_bwd": nu.BWD_COUNTER, "flash_attention_bwd": fa.BWD_COUNTER}
    zero = dict.fromkeys(KERNELS, 0)
    flows = NFE * REQUESTS
    launches = flow_path(dev, counters, "yi-6b", {**zero, "ns_update": flows,
                                                  "flash_attention": LAYERS * flows})
    phase_s = {}
    t0 = time.perf_counter()
    baselines = baselines_served(dev, counters, card)
    phase_s["4b"] = time.perf_counter() - t0
    cfg, params = small_model("yi-6b")
    whole_path_against_cpu(dev, counters, cfg, params,
                           {**zero, "ns_update": 4, "flash_attention": 2 * 4})
    t0 = time.perf_counter()
    baselines_cpu = baselines_against_cpu(dev, counters, cfg, params)
    phase_s["5b"] = time.perf_counter() - t0
    launches["paged_attention"] = decode_path(
        dev, counters, DECODE_ARGS, {"paged_attention": LAYERS})["paged_attention"]
    long_step = long_row_decode_step(dev, counters)
    decode_against_cpu(dev, counters, cfg, params,
                       dict(page_size=16, paged_kernel=True), {"paged_attention": 2})
    del cfg, params
    launches["gla_scan"] = flow_path(
        dev, counters, "rwkv6-7b",
        {**zero, "ns_update": flows, "gla_scan": LAYERS * flows})["gla_scan"]
    cfg, params = small_model("rwkv6-7b")
    whole_path_against_cpu(dev, counters, cfg, params,
                           {**zero, "ns_update": 4, "gla_scan": 2 * 4})
    decode_path(dev, counters, RWKV_DECODE_ARGS, {})
    decode_against_cpu(dev, counters, cfg, params, {}, {})
    del cfg, params
    t0 = time.perf_counter()
    distill = distill_path(dev, counters)
    for name in ("ns_update_bwd", "flash_attention_bwd"):
        launches[name] = distill["launches"][name]
    phase_s["12"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    reload = artifact_reload(dev, counters, distill)
    phase_s["12b"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    any_run = anytime_path(dev, counters)
    phase_s["12c"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    bst_run = bst_distill_path(dev, counters)
    phase_s["12d"] = time.perf_counter() - t0
    cfg, params = small_model("yi-6b")
    t0 = time.perf_counter()
    gradient_against_cpu(dev, counters, cfg, params)
    phase_s["13"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    any_grad = anytime_gradient_against_cpu(dev, counters, cfg, params)
    phase_s["13b"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    bst_grad = bst_gradient_against_cpu(dev, counters, cfg, params)
    phase_s["13c"] = time.perf_counter() - t0
    print("phase wall s: " + ", ".join(f"{k} {v:.1f}" for k, v in phase_s.items()))
    new_phases = {
        "12b": {"what": "artifact reload, 2 requests", "request_ms": reload["request_ms"]},
        "12c": {"what": "anytime distillation and serving",
                "iteration_ms": any_run["iteration_ms"],
                "each_iteration_ms": any_run["each_iteration_ms"],
                "request_ms": any_run["request_ms"],
                "request_nfe": any_run["request_nfe"]},
        "13b": {"what": "anytime gradient, 2 layers f32"},
        "13c": {"what": "BST gradient, 2 layers f32",
                "relative_l2": bst_grad["relative_l2"]},
        "4b": {"what": f"baselines {', '.join(BASELINES)} served, {BASELINE_REQUESTS} "
                       "requests each", "request_ms": baselines["request_ms"]},
        "5b": {"what": "baselines, sigma0 and BST card vs CPU, 2 layers f32",
               "rel_l2": {k: v["rel_l2"] for k, v in baselines_cpu["cases"].items()}},
        "12d": {"what": "BST-Euler distillation, seq 256",
                "each_iteration_ms": bst_run["each_iteration_ms"],
                "training_launches": bst_run["training_launches"]}}

    meta = {
        "ns_update": ("src/repro_torch/kernels/csrc/ns_update.cu",
                      "src/repro/kernels/ns_update/ns_update.py:36"),
        "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention/flash_attention.py:68"),
        "paged_attention": ("src/repro_torch/kernels/csrc/paged_attention.cu",
                            "src/repro/kernels/flash_attention/paged_attention.py:74"),
        "gla_scan": ("src/repro_torch/kernels/csrc/gla_scan.cu",
                     "src/repro/kernels/gla_scan/gla_scan.py:67"),
        "ns_update_bwd": ("src/repro_torch/kernels/csrc/ns_update.cu",
                          "src/repro/kernels/ns_update/ns_update.py:36"),
        "flash_attention_bwd": ("src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
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
        if "yardstick_ms" in main_case:
            kernels[-1]["yardstick"] = {"what": "dense SDPA, gather excluded",
                                        "ms": main_case["yardstick_ms"]}
        if name == "paged_attention":
            kernels[-1]["device_ms"] = main_case["device_ms"]
            kernels[-1]["long_row_decode_step"] = long_step
        if name == "ns_update_bwd":
            kernels[-1]["device_ms"] = main_case["device_ms"]
        if name == "flash_attention_bwd":
            kernels[-1]["library_is"] = "torch autograd of SDPA's backward"
            kernels[-1]["pass_device_ms"] = main_case["pass_device_ms"]
            kernels[-1]["distillation"] = {k: v for k, v in distill.items()
                                           if k not in ("launches", "solver", "latents")}
        if name in ("ns_update", "flash_attention", "ns_update_bwd", "flash_attention_bwd"):
            runs = {"12b": reload, "12c": any_run, "13b": any_grad, "13c": bst_grad,
                    "4b": baselines,
                    "5b": baselines_cpu, "12d": bst_run}
            kernels[-1]["phases"] = {k: {**v, "launches": runs[k]["launches"][name]}
                                     for k, v in new_phases.items()}
    print(f"chip_smoke wall {time.perf_counter() - T_START:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
