#!/usr/bin/env python3
"""Time the MoE feed-forward of qwen3-moe-30b-a3b on the card, one layer at
the served shapes, split into its parts, beside the reference's scatter-add
dispatch.

    PYTHONPATH=src python3 scripts/moe_dispatch_profile.py [--json PATH]

One layer's router and 128 experts (bf16, random from a seed) and a bf16
input at phase 18's flow shape (B=4, S=1024, d=2048: capacity 64 a
sequence, 8192 slots a row) and at the decode shape (B=4, S=1: capacity 8).
For each shape: ``models.moe.moe_mlp_scatter`` (the port: each choice's
position in its expert from a running count laid out (B, E, S·k), an integer
scatter picks each slot's token, the tokens are gathered), the same function
in the reference's form (``scatter_add_dispatch``, kept here as the
yardstick: the count over the middle axis of a (B, S·k, E) one-hot and a
scatter-add of the tokens into a (B, E·C + 1, d) buffer), and the port's
stages timed apart (routing; slot assignment; gather in; the three expert
products; gather out and the weighted sum), each ms a call from CUDA events
over 20 calls after a warm-up, eager. The staged copy is held equal to
``moe_mlp_scatter`` to the bit, and the scatter-add form to it within one
bf16 rounding (the same slots, the same products). One call of each form
under torch.profiler gives its device time and top kernels. The card's name
and power limit head the output; ``--json`` writes every number.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import moe  # noqa: E402

SHAPES = {"flow": (4, 1024), "decode": (4, 1)}
CALLS = 20


def scatter_add_dispatch(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """The reference's dispatch (``repro.models.moe.moe_mlp_scatter``): the
    tokens scatter-added into a (B, E·C + 1, d) buffer, the last slot taking
    every dropped choice."""
    m = cfg.moe
    B, S, d = x.shape
    E, k = m.num_experts, m.top_k
    C = moe._capacity(S, cfg)
    gates, idx, _ = moe._routing(p, x.reshape(B * S, d), cfg)
    gates, idx = gates.reshape(B, S * k), idx.reshape(B, S * k)
    flat = F.one_hot(idx, E).to(torch.int32)
    before = torch.cumsum(flat, dim=1, dtype=torch.int32) - flat
    pos = before.gather(2, idx[..., None])[..., 0]
    keep = pos < C
    dest = torch.where(keep, idx * C + pos, E * C)[..., None].expand(B, S * k, d)
    src = x[:, :, None, :].expand(B, S, k, d).reshape(B, S * k, d)
    buf = torch.zeros((B, E * C + 1, d), dtype=x.dtype, device=x.device).scatter_add(
        1, dest, src)
    xin = buf[:, :-1].reshape(B, E, C, d).transpose(0, 1).reshape(E, B * C, d)
    out = moe._experts(p, xin).reshape(E, B, C, d).transpose(0, 1).reshape(B, E * C, d)
    out = torch.cat([out, torch.zeros((B, 1, d), dtype=x.dtype, device=x.device)], dim=1)
    picked = out.gather(1, dest).reshape(B, S, k, d)
    return torch.sum(picked * (gates * keep).reshape(B, S, k, 1), dim=2)


def staged(p: dict, x: torch.Tensor, cfg, marks: list | None = None) -> torch.Tensor:
    """``moe_mlp_scatter``'s stages, with a CUDA event after each where
    ``marks`` is given."""
    def mark():
        if marks is not None:
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()

    m = cfg.moe
    B, S, d = x.shape
    E, k = m.num_experts, m.top_k
    C = moe._capacity(S, cfg)
    mark()
    gates, idx, _ = moe._routing(p, x.reshape(B * S, d), cfg)
    gates, idx = gates.reshape(B, S * k), idx.reshape(B, S * k)
    mark()
    hits = (idx[:, None, :] == torch.arange(E, device=x.device)[:, None]).to(torch.int32)
    before = torch.cumsum(hits, dim=2, dtype=torch.int32) - hits
    pos_in_e = before.gather(1, idx[:, None, :])[:, 0].long()
    keep = pos_in_e < C
    rows = torch.arange(B, device=x.device)[:, None]
    slot = torch.where(keep, (idx * B + rows) * C + pos_in_e, E * B * C).reshape(B * S * k)
    fill = torch.full((E * B * C + 1,), B * S, dtype=torch.long, device=x.device)
    fill.scatter_(0, slot, torch.arange(B * S * k, device=x.device) // k)
    mark()
    zero = torch.zeros((1, d), dtype=x.dtype, device=x.device)
    xin = torch.cat([x.reshape(B * S, d), zero]).index_select(0, fill[:-1])
    mark()
    out = moe._experts(p, xin.reshape(E, B * C, d)).reshape(E * B * C, d)
    mark()
    picked = torch.cat([out, zero]).index_select(0, slot).reshape(B, S, k, d)
    y = torch.sum(picked * (gates * keep).reshape(B, S, k, 1), dim=2)
    mark()
    return y


def events_ms(fn) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(CALLS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / CALLS


def profiled(fn) -> dict:
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.device_time_total / 1e3) for e in prof.key_averages()
            if e.device_time_total > 0 and e.device_type.name == "CUDA"]
    rows.sort(key=lambda r: -r[1])
    return {"device_ms": sum(t for _, t in rows), "top": rows[:6]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("moe_dispatch_profile: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True, capture_output=True,
                          text=True).stdout.strip()
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = get_config("qwen3-moe-30b-a3b")
    g = torch.Generator(device=dev).manual_seed(0)
    p = {k: v.to(torch.bfloat16) for k, v in moe.init_moe_mlp(g, cfg).items()}
    result = {"card": card}
    with torch.no_grad():
        for name, (B, S) in SHAPES.items():
            x = torch.randn((B, S, cfg.d_model), generator=g, device=dev).to(torch.bfloat16)
            port = moe.moe_mlp_scatter(p, x, cfg)[0]
            marks: list = []
            same = bool(torch.equal(staged(p, x, cfg, marks), port))
            old = scatter_add_dispatch(p, x, cfg)
            rel = float((old.float() - port.float()).norm() / port.float().norm())
            _, idx, _ = moe._routing(p, x.reshape(B * S, -1), cfg)
            C = moe._capacity(S, cfg)
            load = torch.bincount((idx.reshape(B, -1) + cfg.moe.num_experts
                                   * torch.arange(B, device=dev)[:, None]).reshape(-1),
                                  minlength=B * cfg.moe.num_experts)
            dropped = float(torch.clamp(load - C, min=0).sum() / idx.numel())
            parts = {}
            for _ in range(CALLS):
                marks = []
                staged(p, x, cfg, marks)
                torch.cuda.synchronize()
                for stage, (a, b) in zip(("routing", "slots", "gather in", "experts",
                                          "gather out and sum"), zip(marks, marks[1:])):
                    parts.setdefault(stage, []).append(a.elapsed_time(b))
            parts = {k: sorted(v)[len(v) // 2] for k, v in parts.items()}
            row = {"B": B, "S": S, "capacity": C, "dropped_share": dropped,
                   "port_ms": events_ms(lambda: moe.moe_mlp_scatter(p, x, cfg)),
                   "scatter_add_ms": events_ms(lambda: scatter_add_dispatch(p, x, cfg)),
                   "parts_ms": parts, "staged_equal_to_port": same,
                   "scatter_add_rel_l2": rel,
                   "port_profile": profiled(lambda: moe.moe_mlp_scatter(p, x, cfg)),
                   "scatter_add_profile": profiled(lambda: scatter_add_dispatch(p, x, cfg))}
            result[name] = row
            print(f"{name} (B={B} S={S}, capacity {C}, {100 * dropped:.1f}% of choices "
                  f"dropped): port {row['port_ms']:.3f} ms a layer, scatter-add dispatch "
                  f"{row['scatter_add_ms']:.3f} ms; port's parts "
                  + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
                  + f" ms; staged equal to the port {same}; scatter-add vs port relative "
                  f"L2 {rel:.2e}; device ms port {row['port_profile']['device_ms']:.3f}, "
                  f"scatter-add {row['scatter_add_profile']['device_ms']:.3f}")
            for label in ("port_profile", "scatter_add_profile"):
                print(f"  {label} top kernels: " + "; ".join(
                    f"{k[:60]} {t:.3f}" for k, t in row[label]["top"]))
            if not same or not rel < 1e-2:
                raise SystemExit(f"{name}: the staged copy or the scatter-add form "
                                 f"disagrees with the port ({same}, {rel})")
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
