"""Mamba2 (SSD) blocks and the Zamba2 hybrid [arXiv:2411.15242].

Port of ``repro.models.mamba2``. Zamba2-2.7b: a backbone of Mamba2 blocks
with ONE weight-shared GQA attention block applied every
``hybrid_attn_every`` layers (the paper's 'shared attention': its parameters
are reused at every application site, but each site keeps its own KV cache).

Mamba2 block: in_proj -> (z, xBC, dt); depthwise causal conv over xBC; the
SSD recurrence (decay dt * -exp(A_log), one per head; state (d_state,
head_dim)); D skip; gated RMSNorm; out_proj. As in the reference, B and C are
one group (ngroups = 1), broadcast over the heads.

The full-sequence pass (flow) runs the recurrence through ``kernels.gla_scan``
(the CUDA kernel on the card, ``gla_chunked`` on the CPU) in the inclusive
mode with one decay per head, q and k as stride-0 views over the heads, and
the shared attention through ``attention_forward`` (the flash kernel on the
card). Decode carries ``HybridState`` and steps the recurrence with the plain
``gla_step`` and the shared attention over a dense KV cache a site, as the
reference does; it writes the state IN PLACE. Layer params are stacked on a
leading axis and every pass is a Python loop over it where the reference
scans. ``lm_forward`` is not ported, as the dense family's is not.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.gla_scan import ops as gla_ops
from repro_torch.models.attention import (
    KVCache,
    attention_forward,
    decode_attention,
    init_attention,
)
from repro_torch.models.layers import dense_init, rms_norm, swiglu
from repro_torch.models.linear_scan import gla_step
from repro_torch.models.transformer import (
    cast_params,
    generator_device,
    init_flow_head,
    init_stacked_layers,
    layer_views,
    transfer_params,
)

Tensor = torch.Tensor


class HybridState(NamedTuple):
    conv: Tensor     # (L, B, d_conv-1, conv_dim) conv tail buffer
    ssm: Tensor      # (L, B, nheads, d_state, head_dim) f32
    kv: Tensor       # (sites, B, slots, n_kv, hd) shared-attn K cache, one a site
    vv: Tensor       # same for V
    index: Tensor    # scalar or (B,) int32 position


def _dims(cfg: ModelConfig) -> tuple[int, int, int]:
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.d_state
    return d_inner, n_heads, conv_dim


def _mamba_init(generator: torch.Generator, cfg: ModelConfig) -> dict:
    """One Mamba2 block's f32 params on the generator's device."""
    s = cfg.ssm
    d_inner, n_heads, conv_dim = _dims(cfg)
    full = lambda shape, value: torch.full(shape, value, dtype=torch.float32,  # noqa: E731
                                           device=generator.device)
    return {
        "in_proj": dense_init(generator, cfg.d_model, 2 * d_inner + 2 * s.d_state + n_heads),
        "conv_w": torch.randn((s.d_conv, conv_dim), generator=generator,
                              dtype=torch.float32, device=generator.device).mul_(0.1),
        "A_log": full((n_heads,), 0.0),                  # A = -1
        "D": full((n_heads,), 1.0),
        "dt_bias": full((n_heads,), -2.0),               # softplus ~ 0.12
        "gate_norm": full((d_inner,), 1.0),
        "out_proj": dense_init(generator, d_inner, cfg.d_model),
        "norm": full((cfg.d_model,), 1.0),
    }


def init_shared_attn(generator: torch.Generator, cfg: ModelConfig) -> dict:
    """The shared attention block's f32 params on the generator's device."""
    ones = lambda: torch.ones((cfg.d_model,), dtype=torch.float32,  # noqa: E731
                              device=generator.device)
    return {
        "attn": init_attention(generator, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                               cfg.resolved_head_dim),
        "mlp": {
            "w_gate": dense_init(generator, cfg.d_model, cfg.d_ff),
            "w_up": dense_init(generator, cfg.d_model, cfg.d_ff),
            "w_down": dense_init(generator, cfg.d_ff, cfg.d_model),
        },
        "norm1": ones(),
        "norm2": ones(),
    }


def init_hybrid_params(generator: torch.Generator, cfg: ModelConfig, device="cuda") -> dict:
    """Random params in the reference's tree layout, built layer by layer on
    ``device`` (the generator's), cast by ``cast_params``' rule: the stacked
    per-layer leaves (``A_log``, ``D``, ``dt_bias``, ``gate_norm`` and
    ``norm`` included) take ``cfg.dtype``; only the 1-D ``final_norm`` and the
    shared block's ``norm1`` and ``norm2`` stay f32."""
    if cfg.n_layers % cfg.hybrid_attn_every:
        raise ValueError(f"n_layers {cfg.n_layers} is not a multiple of "
                         f"hybrid_attn_every {cfg.hybrid_attn_every}")
    dev = generator_device(generator, device)
    dtype = getattr(torch, cfg.dtype)
    layers = init_stacked_layers(lambda: _mamba_init(generator, cfg), cfg.n_layers,
                                 dtype, dev)
    return {
        "embed": dense_init(generator, cfg.vocab, cfg.d_model, scale=1.0).to(dtype),
        "layers": layers,
        "shared_attn": cast_params(init_shared_attn(generator, cfg), dtype),
        "final_norm": torch.ones((cfg.d_model,), dtype=torch.float32, device=dev),
        "lm_head": dense_init(generator, cfg.d_model, cfg.vocab).to(dtype),
        "flow": cast_params(init_flow_head(generator, cfg), dtype),
    }


_LAYER_KEYS = {"in_proj", "conv_w", "A_log", "D", "dt_bias", "gate_norm", "out_proj", "norm"}


def params_from_jax(tree: dict, cfg: ModelConfig, device="cuda", dtype=None) -> dict:
    """The port's params from the reference's hybrid tree, already numpy
    (``jax.tree.map(np.asarray, params)``): the same layout, transferred."""
    if set(tree.get("layers", {})) != _LAYER_KEYS:
        raise ValueError(f"layer tree has {sorted(tree.get('layers', {}))}, "
                         f"expected {sorted(_LAYER_KEYS)}")
    return transfer_params(tree, {"embed", "layers", "shared_attn", "final_norm",
                                  "lm_head", "flow"}, device, dtype)


def _ssd(cfg: ModelConfig, x: Tensor, B_: Tensor, C_: Tensor, dt: Tensor, p: dict,
         s0: Optional[Tensor] = None, chunk: Optional[int] = None
         ) -> tuple[Tensor, Tensor]:
    """x: (B, L, d_inner); B_, C_: (B, L, d_state); dt: (B, L, nheads).
    Returns (y (B, L, d_inner), final state (B, nheads, d_state, head_dim) f32)."""
    s = cfg.ssm
    d_inner, n_heads, _ = _dims(cfg)
    Bsz, L, _ = x.shape
    dt = F.softplus(dt.to(torch.float32) + p["dt_bias"])
    ld = dt * (-torch.exp(p["A_log"]))                          # (B, L, nh) f32
    xh = x.reshape(Bsz, L, n_heads, s.head_dim)
    v = xh * dt[..., None].to(xh.dtype)
    # one B/C group: views with a stride of 0 over the heads, no copy
    k = B_[:, :, None, :].expand(Bsz, L, n_heads, s.d_state)
    q = C_[:, :, None, :].expand(Bsz, L, n_heads, s.d_state)
    # one decay per (head, step): ld's trailing dim of 1
    o, S = gla_ops.gla(q, k, v, ld[..., None], s0, inclusive=True, chunk=chunk or s.chunk)
    y = o + p["D"][:, None].to(o.dtype) * xh
    return y.reshape(Bsz, L, d_inner), S


def mamba_block_seq(p: dict, cfg: ModelConfig, h: Tensor, chunk: Optional[int] = None
                    ) -> Tensor:
    s = cfg.ssm
    d_inner, n_heads, conv_dim = _dims(cfg)
    hn = rms_norm(h, p["norm"], cfg.norm_eps)
    z, xBC, dt = torch.split(hn @ p["in_proj"], [d_inner, conv_dim, n_heads], dim=-1)
    # depthwise causal conv of width d_conv, summed tap by tap (the reference's order)
    L = xBC.shape[1]
    pad = torch.zeros((xBC.shape[0], s.d_conv - 1, conv_dim), dtype=xBC.dtype,
                      device=xBC.device)
    xp = torch.cat([pad, xBC], dim=1)
    conv = sum(xp[:, i:i + L] * p["conv_w"][i].to(xBC.dtype) for i in range(s.d_conv))
    x, B_, C_ = torch.split(F.silu(conv), [d_inner, s.d_state, s.d_state], dim=-1)
    y, _ = _ssd(cfg, x, B_, C_, dt, p, chunk=chunk)
    y = rms_norm(y * F.silu(z), p["gate_norm"], cfg.norm_eps)
    return h + y @ p["out_proj"]


def mamba_block_step(p: dict, cfg: ModelConfig, h: Tensor, conv_state: Tensor,
                     S: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """h: (B, d); conv_state: (B, d_conv-1, conv_dim); S: (B, nh, ds, hd).
    Returns (h, new conv_state in h's dtype, new S f32)."""
    s = cfg.ssm
    d_inner, n_heads, conv_dim = _dims(cfg)
    hn = rms_norm(h, p["norm"], cfg.norm_eps)
    z, xBC, dt = torch.split(hn @ p["in_proj"], [d_inner, conv_dim, n_heads], dim=-1)
    window = torch.cat([conv_state.to(xBC.dtype), xBC[:, None]], dim=1)
    conv = torch.einsum("bkc,kc->bc", window, p["conv_w"].to(xBC.dtype))
    x, B_, C_ = torch.split(F.silu(conv), [d_inner, s.d_state, s.d_state], dim=-1)
    dtf = F.softplus(dt.to(torch.float32) + p["dt_bias"])
    ld = dtf * (-torch.exp(p["A_log"]))
    xh = x.reshape(-1, n_heads, s.head_dim)
    v = xh * dtf[..., None].to(xh.dtype)
    shape = xh.shape[:2] + (s.d_state,)
    k = B_[:, None, :].expand(shape)
    q = C_[:, None, :].expand(shape)
    o, S = gla_step(q, k, v, ld[..., None].expand(shape), S, inclusive=True)
    y = (o + p["D"][:, None].to(o.dtype) * xh).reshape(-1, d_inner)
    y = rms_norm(y * F.silu(z), p["gate_norm"], cfg.norm_eps)
    return h + y @ p["out_proj"], window[:, 1:], S


def _shared_attn_seq(p: dict, cfg: ModelConfig, h: Tensor, positions: Tensor,
                     window: int = 0) -> Tensor:
    h = h + attention_forward(p["attn"], rms_norm(h, p["norm1"], cfg.norm_eps),
                              positions, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                              head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
                              causal=True, window=window, norm_eps=cfg.norm_eps)
    return h + swiglu(rms_norm(h, p["norm2"], cfg.norm_eps), **p["mlp"])


def _superblock(shared: dict, group: list, cfg: ModelConfig, h: Tensor,
                positions: Tensor, window: int) -> Tensor:
    """The shared attention, then the group's Mamba2 blocks."""
    h = _shared_attn_seq(shared, cfg, h, positions, window)
    for p in group:
        h = mamba_block_seq(p, cfg, h)
    return h


def hybrid_hidden(params: dict, cfg: ModelConfig, h: Tensor, positions=None, *,
                  window: int = 0, remat: bool = False) -> Tensor:
    """Full-sequence forward (flow): h (B, L, d) -> final-normed hidden, over
    n_layers / hybrid_attn_every superblocks. ``remat`` recomputes each
    superblock in the backward, as the reference's ``jax.checkpoint`` of its
    scan body does."""
    k = cfg.hybrid_attn_every
    if positions is None:
        positions = torch.arange(h.shape[1], device=h.device)
    layers = layer_views(params["layers"])
    for site in range(cfg.n_layers // k):
        group = layers[site * k:site * k + k]
        if remat:
            h = checkpoint(_superblock, params["shared_attn"], group, cfg, h, positions,
                           window, use_reentrant=False)
        else:
            h = _superblock(params["shared_attn"], group, cfg, h, positions, window)
    return rms_norm(h, params["final_norm"], cfg.norm_eps)


def init_state(cfg: ModelConfig, batch: int, slots: int, dtype=torch.bfloat16,
               device="cuda") -> HybridState:
    """Zeroed decode state: conv tails and KV caches in ``dtype``, the SSD
    state in f32, a scalar index (the reference's default)."""
    s = cfg.ssm
    dev = resolve_device(device)
    _, n_heads, conv_dim = _dims(cfg)
    sites = cfg.n_layers // cfg.hybrid_attn_every
    kv_shape = (sites, batch, slots, cfg.n_kv_heads, cfg.resolved_head_dim)
    return HybridState(
        conv=torch.zeros((cfg.n_layers, batch, s.d_conv - 1, conv_dim), dtype=dtype,
                         device=dev),
        ssm=torch.zeros((cfg.n_layers, batch, n_heads, s.d_state, s.head_dim),
                        dtype=torch.float32, device=dev),
        kv=torch.zeros(kv_shape, dtype=dtype, device=dev),
        vv=torch.zeros(kv_shape, dtype=dtype, device=dev),
        index=torch.zeros((), dtype=torch.int32, device=dev))


def decode_step(params: dict, cfg: ModelConfig, token: Tensor, state: HybridState, *,
                window: int = 0, active: Optional[Tensor] = None
                ) -> tuple[Tensor, HybridState]:
    """One-token decode: token (B,) -> (logits (B, V), state).

    ``state`` is updated IN PLACE: conv and ssm in the rows where ``active``
    (B,) bool is True (all rows when None), each site's K/V through
    ``decode_attention`` in the same rows; the other rows keep every bit.
    The index advances in place too (only the active rows' when ``active``
    is given), and ``state`` is returned."""
    h = params["embed"][token.long()]                                # (B, d)
    k = cfg.hybrid_attn_every
    sp = params["shared_attn"]
    keep = None if active is None else active.to(torch.bool)
    attn_kw = dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                   head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
                   window=window, norm_eps=cfg.norm_eps)

    def write(leaf: Tensor, new: Tensor) -> None:
        if keep is None:
            leaf.copy_(new)
        else:
            leaf.copy_(torch.where(keep.reshape((-1,) + (1,) * (leaf.dim() - 1)),
                                   new.to(leaf.dtype), leaf))

    layers = layer_views(params["layers"])
    for site in range(cfg.n_layers // k):
        cache = KVCache(k=state.kv[site], v=state.vv[site], index=state.index)
        hn = rms_norm(h[:, None], sp["norm1"], cfg.norm_eps)
        attn_out, _ = decode_attention(sp["attn"], hn, cache, active=keep, **attn_kw)
        h = h + attn_out[:, 0]
        h = h + swiglu(rms_norm(h, sp["norm2"], cfg.norm_eps), **sp["mlp"])
        for i in range(site * k, (site + 1) * k):
            h, conv, S = mamba_block_step(layers[i], cfg, h,
                                          state.conv[i], state.ssm[i])
            write(state.conv[i], conv)
            write(state.ssm[i], S)
    logits = rms_norm(h, params["final_norm"], cfg.norm_eps) @ params["lm_head"]
    index = state.index + 1
    if keep is not None:
        index = torch.where(keep, index, state.index)
    state.index.copy_(index)
    return logits, state
