"""Serving-substrate demo on the port: batched autoregressive decode across
architecture families — KV-cache GQA (dense), recurrent state (RWKV6), the
hybrid Mamba2+shared-attention state and MoE — plus the sliding-window ring
buffer that makes long_500k decode sub-quadratic for dense models, and the
decode gateway's continuous slot refill multiplexing mixed-length prompts onto
one slot pool.

  PYTHONPATH=src python examples/torch/serve_decode.py [--device cpu]

The twin of ``examples/serve_decode.py`` on ``repro_torch``. Runs on the card
unless ``--device cpu`` is given (exits non-zero without one); the weights
come from a seeded ``torch.Generator`` (``demo`` also takes given ones).
``--batch`` and ``--steps`` cut the greedy runs (defaults: the reference's 4
and 24).
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.models import model as M
from repro_torch.serving.decode import DecodeGateway, DecodeRequest
from repro_torch.serving.engine import DecodeEngine, greedy_demo

BATCH, STEPS = 4, 24
FAMILIES = ("yi-6b", "rwkv6-7b", "zamba2-2.7b", "qwen3-moe-30b-a3b")
GATEWAY_SLOTS = 2


def demo(arch: str, device, window: int = 0, slots: int = 64, batch: int = BATCH,
         steps: int = STEPS, params=None) -> torch.Tensor:
    """``steps`` greedy tokens for ``batch`` rows of ``arch``'s smoke model
    (the weights drawn from seed 0 unless ``params`` is given); prints one
    line and returns the tokens (batch, steps) on the host."""
    cfg = get_config(arch, smoke=True)
    if params is None:
        params = M.init_params(torch.Generator(device=device).manual_seed(0), cfg, device)
    engine = DecodeEngine(params=params, cfg=cfg, window=window)
    tokens, dt = greedy_demo(engine, batch, steps, slots)
    kind = f"window={window}" if window else \
        ("recurrent state" if cfg.family in ("ssm", "hybrid") else "full cache")
    print(f"  {arch:16s} [{cfg.family:6s}] {steps} tokens x {batch} seqs, "
          f"{kind}: {dt:.1f} ms/token  sample={tokens[0, :6].tolist()}")
    return tokens


def demo_gateway(device, arch: str = "yi-6b", max_slots: int = GATEWAY_SLOTS) -> dict:
    """Mixed-length prompts through the continuous-batching decode gateway:
    a finished sequence frees its slot and the next prompt joins mid-flight
    (join_step > 0), bit-identical to decoding it alone. Returns the
    responses' metadata and the gateway's stats."""
    cfg = get_config(arch, smoke=True)
    params = M.init_params(torch.Generator(device=device).manual_seed(0), cfg, device)
    gw = DecodeGateway(DecodeEngine(params=params, cfg=cfg), max_slots=max_slots,
                       cache_slots=64)
    gw.start()
    futs = [gw.submit(DecodeRequest(prompt=[1 + i, 2 + i], max_tokens=t))
            for i, t in enumerate((12, 4, 8))]
    gw.shutdown()
    metas = []
    for i, f in enumerate(futs):
        meta = f.result().meta
        metas.append(meta)
        print(f"  request {i}: {meta['new_tokens']} tokens, slot "
              f"{meta['slot']}, join_step {meta['join_step']}")
    s = gw.stats()
    print(f"  {s['completed']} sequences over {s['forwards']} engine steps "
          f"({max_slots} slots, occupancy {s['slot_occupancy']:.2f}, "
          f"{s['joins']} mid-flight joins)")
    return {"metas": metas, "stats": s}


def main(argv=None) -> dict:
    """Returns each demo's tokens by name and the gateway's record."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--steps", type=int, default=STEPS)
    args = ap.parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(str(e)) from None
    out = {}
    print("batched greedy decode across the family zoo:")
    for arch in FAMILIES:
        out[arch] = demo(arch, dev, batch=args.batch, steps=args.steps)
    print("sliding-window ring buffer (long-context mechanism, window=8):")
    out["yi-6b window=8"] = demo("yi-6b", dev, window=8, slots=8, batch=args.batch,
                                 steps=args.steps)
    print(f"continuous decode batching ({GATEWAY_SLOTS} slots, mixed lengths):")
    out["gateway"] = demo_gateway(dev)
    return out


if __name__ == "__main__":
    main()
