#!/usr/bin/env python3
"""How far f32 holds the BNS gradient on each backbone, and what the kernels
add: ``chip_smoke.py``'s gradient check (phases 13 and 26b-28b) taken against
the same computation in f64 on the CPU.

    PYTHONPATH=src python3 scripts/grad_f32_conditioning.py [--archs rwkv6-7b ...]

For each arch, its width cut to a few layers (rwkv6-7b 1, zamba2-2.7b 2 with
one shared-attention site, whisper-medium 1 + 1, yi-6b 2), f32 weights drawn
on the card and copied to the CPU, ``_loss_fn`` at euler NFE 4 on seeded
pairs (batch 2 x 128, each layer recomputed) and its gradient in theta
(time logits, a, b), computed five ways: on the card through the kernels;
on the card with ``GLAScan``'s backward replaced by the plain backward in f64
(``ref.gla_chunked_bwd``), and with the plain chunked form differentiated by
autograd on the card in place of both gla_scan kernels (the recurrent
families only); on the CPU in f32; on the CPU in f64 (the weights and pairs
cast). Prints each one's relative L2 distance from the f64 result, and
from the CPU's f32 one, for the loss and each gradient. Where the kernels
add nothing, the two card variants read what the card does through the
kernels. Prints the card's name and power limit first; TF32 off. Needs one
card.

    PYTHONPATH=src python3 scripts/grad_f32_conditioning.py --parts

takes rwkv6-7b at 1 layer apart instead: the card's gradient with one part of
the layer at a time computed in f64 (inputs cast up, the result cast back to
f32; the recurrence stays on the f32 kernels), and with the whole layer but
the recurrence in f64 (the layer's input and output f32). The model's rms_norm and decay cast to f32 even for f64
inputs; here both keep f64 (``rms_norm_kept``, ``decay_kept``), so the CPU's
f64 gradient is f64 throughout (the 26b form, with those two casts, is
printed beside it). Each variant's distance from the CPU's f64 gradient says
how much of the card's distance that part's f32 arithmetic accounts for.
Besides the layer's parts, the three outside it: the time embedding
(``layers.timestep_embedding``'s sin / cos features, its angles up to 1000
rad), the rest of the flow head (``transformer.flow_velocity`` outside the
layer stack: proj_in, the tokens' embedding, the time MLP, proj_out; the
stack keeps f32) and the solver's update (``a x0 + sum_j w_j U_j`` and its
backward, in place of the ``ns_update`` kernels).
"""
from __future__ import annotations

import argparse
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

DEPTH = {"rwkv6-7b": 1, "zamba2-2.7b": 2, "whisper-medium": 1, "yi-6b": 2}


def loss_and_grads(cfg, params, device, dtype=torch.float32) -> list:
    """[loss, d/d time_logits, d/da, d/db] in f64 on the CPU."""
    from repro_torch.core import bns, ns_solver
    from repro_torch.core.schedulers import get_scheduler
    from repro_torch.data.synthetic import DataConfig, SyntheticTokens
    from repro_torch.models import model as M
    from repro_torch.solvers.registry import build_ns

    batch = SyntheticTokens(cfg, DataConfig(batch_size=2, seq_len=128, seed=0),
                            device="cpu").batch(0)
    rng = np.random.default_rng(13)
    x0, x1 = (torch.from_numpy(rng.standard_normal((2, 128, cfg.latent_dim))
                               .astype(np.float32)).to(device, dtype) for _ in "01")
    theta0 = ns_solver.from_ns(build_ns("euler", 4, None))
    field = M.velocity_field(params, cfg, get_scheduler("fm_ot"),
                             {k: v.to(device) for k, v in batch.items()}, remat=True)
    th = ns_solver.BNSParams(*(p.to(device, dtype).requires_grad_(True) for p in theta0))
    loss = bns._loss_fn(bns.ns_sampler(field), th, x0, x1)
    grads = torch.autograd.grad(loss, list(th))
    return [loss.detach().double().cpu()] + [g.double().cpu() for g in grads]


def _cast(x, dtype):
    if isinstance(x, torch.Tensor) and x.is_floating_point():
        return x.to(dtype)
    if isinstance(x, dict):
        return {k: _cast(v, dtype) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_cast(v, dtype) for v in x)
    return x


def in_f64(fn):
    """fn with its floating-point tensor arguments (params dicts included)
    cast to f64 and its results cast back to f32."""
    def wrapped(*args, **kw):
        return _cast(fn(*_cast(args, torch.float64), **_cast(kw, torch.float64)),
                     torch.float32)
    return wrapped


def with_f32_gla():
    """ops.gla on the f32 kernels for f64 callers: inputs cast down, the
    output and state cast back to the caller's dtype (a context)."""
    from repro_torch.kernels.gla_scan import ops

    inner = ops.gla

    def gla(q, k, v, ld, s0=None, *, inclusive=True, chunk=64):
        out = inner(*_cast((q, k, v, ld, s0), torch.float32), inclusive=inclusive,
                    chunk=chunk)
        return _cast(out, v.dtype)

    return _patched(ops, "gla", gla)


def rms_norm_kept(x, weight, eps: float = 1e-5):
    """layers.rms_norm in x's dtype where that is f64 (the model's casts to
    f32 whatever x is); the same f32 arithmetic otherwise."""
    from repro_torch.models.layers import rms_norm

    if x.dtype != torch.float64:
        return rms_norm(x, weight, eps)
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * weight.to(x.dtype)


def decay_kept(decay):
    """rwkv6._decay (``decay``) in m_w's dtype where that is f64 (the model's
    casts the exponent to f32); the same f32 arithmetic otherwise."""
    def kept(p, m_w):
        if m_w.dtype != torch.float64:
            return decay(p, m_w)
        lora = torch.tanh(m_w @ p["w_lora_a"]) @ p["w_lora_b"]
        return -torch.exp(p["w0"].to(m_w.dtype) + lora)
    return kept


# part -> the rwkv6 module's functions computed in f64 for it
PARTS = {
    "decay -exp(w0 + lora)": ("_decay",),
    "token-shift mixes": ("_mixes",),
    "rms_norm (norm1, norm2, ln_x, final)": ("rms_norm",),
    "channel mix (its f32 matmuls, relu^2, sigmoid)": ("_channel_mix",),
    "time mix but the recurrence (projections, decay, mixes, bonus, ln_x)":
        ("_time_mix_seq",),
    "the whole layer but the recurrence": ("_seq_layer",),
}


def timestep_embedding_f64(t, dim: int, max_period: float = 10_000.0, *, device=None):
    """layers.timestep_embedding with its angles, sin and cos in f64 (t read
    as given); the caller casts the features to its dtype."""
    t = torch.atleast_1d(torch.as_tensor(t, device=device)).double()
    half = dim // 2
    freqs = torch.exp(-np.log(max_period) * torch.arange(half, dtype=torch.float64,
                                                          device=t.device) / half)
    ang = t[..., None] * freqs * 1000.0
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)


def flow_head_f64(flow_velocity, params64: dict):
    """transformer.flow_velocity with the head's arithmetic in f64: the
    ``flow`` and ``embed`` leaves from ``params64``, x and t cast up; the
    layer stack (``hidden_fn``) runs on the caller's f32 params, its input
    cast down and its output back up; the velocity cast to x's dtype."""
    from repro_torch.models import transformer

    def head(params, cfg, t, x, cond_tokens, *, hidden_fn=None):
        inner = hidden_fn or (lambda p, c, h, pos: transformer.dense_hidden(p, c, h, pos))

        def stack(p, c, h, pos):
            return inner(params, c, h.to(x.dtype), pos).double()

        t64 = t.double() if isinstance(t, torch.Tensor) else t
        return flow_velocity({**params, **params64}, cfg, t64, x.double(), cond_tokens,
                             hidden_fn=stack).to(x.dtype)
    return head


def ns_update_f64(x0, u, a, w):
    """The solver's update ``a x0 + sum_j w_j u_j`` in f64, cast to x0's dtype
    (autograd differentiates it in f64 too)."""
    acc = a.double() * x0.double() + torch.tensordot(w.double(), u.double(), dims=([0], [0]))
    return acc.to(x0.dtype)


def outside_parts(on_card: dict) -> dict:
    """part -> the patches that compute it in f64 (the parts outside the layer)."""
    from repro_torch.core import ns_solver
    from repro_torch.models import transformer

    params64 = {"flow": _cast(on_card["flow"], torch.float64),
                "embed": on_card["embed"].double()}
    return {
        "the time embedding (sin / cos features)":
            lambda: [_patched(transformer, "timestep_embedding", timestep_embedding_f64)],
        "the flow head (proj_in, token embedding, time MLP, proj_out)":
            lambda: [_patched(transformer, "flow_velocity",
                              flow_head_f64(transformer.flow_velocity, params64))],
        "the solver's update (a x0 + sum w U, forward and backward)":
            lambda: [_patched(ns_solver, "fused_ns_update", ns_update_f64)],
    }


def parts_report(dev) -> None:
    """rwkv6-7b at 1 layer, f32 on the card, one part at a time in f64."""
    from repro_torch.models import rwkv6
    from repro_torch.optim.adam import tree_map

    arch = "rwkv6-7b"
    cfg, on_card, on_cpu = chip_smoke.card_drawn_model(dev, arch, 1)
    cfg64 = dataclasses.replace(cfg, dtype="float64")
    as64 = lambda params: tree_map(lambda t: t.double(), params)  # noqa: E731
    runs = {"card": loss_and_grads(cfg, on_card, dev),
            "cpu f64 (rms_norm and the decay round to f32, as 26b's)":
                loss_and_grads(cfg64, as64(on_cpu), "cpu", torch.float64)}
    kept = [_patched(rwkv6, "rms_norm", rms_norm_kept),
            _patched(rwkv6, "_decay", decay_kept(rwkv6._decay))]
    for ctx in kept:
        ctx.__enter__()
    try:
        for part, names in PARTS.items():
            patches = [_patched(rwkv6, n, in_f64(getattr(rwkv6, n))) for n in names]
            for ctx in patches:
                ctx.__enter__()
            try:
                with with_f32_gla():
                    runs[f"card, {part} in f64"] = loss_and_grads(cfg, on_card, dev)
            finally:
                for ctx in reversed(patches):
                    ctx.__exit__()
        for part, make in outside_parts(on_card).items():
            patches = make()
            for ctx in patches:
                ctx.__enter__()
            try:
                runs[f"card, {part} in f64"] = loss_and_grads(cfg, on_card, dev)
            finally:
                for ctx in reversed(patches):
                    ctx.__exit__()
        runs["cpu f32"] = loss_and_grads(cfg, on_cpu, "cpu")
        runs["cpu f64"] = loss_and_grads(cfg64, as64(on_cpu), "cpu", torch.float64)
    finally:
        for ctx in reversed(kept):
            ctx.__exit__()
    for name, got in runs.items():
        f64 = distances(got, runs["cpu f64"])
        card = distances(got, runs["card"])
        print(f"{arch} (1 layer f32) {name}: relative L2 of loss, d/d time_logits, d/da, "
              f"d/db against the CPU's f64 {[f'{x:.2e}' for x in f64]}, against the "
              f"card's f32 {[f'{x:.2e}' for x in card]}")


def distances(got: list, want: list) -> list:
    return [float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b).clamp_min(1e-30))
            for a, b in zip(got, want)]


def with_plain_gla_backward():
    """GLAScan's backward through ref.gla_chunked_bwd in f64 (a context)."""
    from repro_torch.kernels.gla_scan import ops
    from repro_torch.kernels.gla_scan.ref import gla_chunked_bwd

    def backward(ctx, do, dS):
        saved = ctx.saved_tensors
        f64 = [None if t is None else t.double() for t in (*saved, do, dS)]
        got = gla_chunked_bwd(*f64, inclusive=ctx.inclusive, chunk=ctx.chunk)
        return tuple(None if g is None else g.to(t.dtype)
                     for g, t in zip(got, saved)) + (None, None)

    return _patched(ops.GLAScan, "backward", staticmethod(backward))


def with_plain_gla_forward():
    """ops.gla as the plain chunked form on the card (autograd differentiates it)."""
    from repro_torch.kernels.gla_scan import ops
    from repro_torch.models.linear_scan import gla_chunked

    def gla(q, k, v, ld, s0=None, *, inclusive=True, chunk=64):
        return gla_chunked(*ops._heads(q, k, v), v, ld, s0, inclusive=inclusive, chunk=chunk)

    return _patched(ops, "gla", gla)


class _patched:
    def __init__(self, owner, name, value):
        self.owner, self.name, self.value = owner, name, value

    def __enter__(self):
        self.saved = self.owner.__dict__[self.name]
        setattr(self.owner, self.name, self.value)

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.saved)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--archs", nargs="+", default=list(DEPTH), choices=list(DEPTH))
    ap.add_argument("--parts", action="store_true",
                    help="rwkv6-7b at 1 layer, one part of the layer at a time in f64")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("grad_f32_conditioning: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True, capture_output=True,
                         text=True).stdout.strip())
    from repro_torch.optim.adam import tree_map

    if args.parts:
        parts_report(dev)
        return 0
    for arch in args.archs:
        cfg, on_card, on_cpu = chip_smoke.card_drawn_model(dev, arch, DEPTH[arch])
        runs = {"card": loss_and_grads(cfg, on_card, dev)}
        if cfg.family in ("ssm", "hybrid"):
            with with_plain_gla_backward():
                runs["card, the backward in f64 (plain)"] = loss_and_grads(cfg, on_card, dev)
            with with_plain_gla_forward():
                runs["card, the plain form by autograd"] = loss_and_grads(cfg, on_card, dev)
        runs["cpu f32"] = loss_and_grads(cfg, on_cpu, "cpu")
        runs["cpu f64"] = loss_and_grads(dataclasses.replace(cfg, dtype="float64"),
                                         tree_map(lambda t: t.double(), on_cpu), "cpu",
                                         torch.float64)
        for name, got in runs.items():
            f64 = distances(got, runs["cpu f64"])
            f32 = distances(got, runs["cpu f32"])
            print(f"{arch} ({DEPTH[arch]} layers f32) {name}: relative L2 of loss, d/d "
                  f"time_logits, d/da, d/db against the CPU's f64 "
                  f"{[f'{x:.2e}' for x in f64]}, against its f32 {[f'{x:.2e}' for x in f32]}")
        print(f"{arch}: d/d time_logits in f64 {runs['cpu f64'][1].tolist()}")
        del on_card, on_cpu, runs
        chip_smoke.free_device_memory(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
