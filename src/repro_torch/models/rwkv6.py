"""RWKV6 "Finch" — attention-free RNN with data-dependent decay
[arXiv:2404.05892].

Port of ``repro.models.rwkv6``. Per layer: a time-mix block (the wkv6 linear
recurrence with per-channel, data-dependent decay from a LoRA on the
token-shifted input, plus the 'bonus' u term) and a channel-mix block
(squared-ReLU FFN with receptance gating). Token shift is the RWKV one-step
convolution. The reference's simplifications hold here too: the five token
mixes use static per-channel mu, and the wkv output's GroupNorm is a per-head
RMSNorm.

The full-sequence pass (flow) runs the recurrence through ``kernels.gla_scan``
(the CUDA kernel on the card, ``gla_chunked`` on the CPU), in the exclusive
mode with dk = dv = 64. Decode carries ``RWKVState`` (token shifts and the
wkv state: O(1) in sequence length) and steps it with the plain ``gla_step``,
as the reference does. Layer params are stacked on a leading axis and every
pass is a Python loop over it where the reference scans.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.gla_scan import ops as gla_ops
from repro_torch.models.layers import dense_init, rms_norm
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

HEAD_DIM = 64
LORA_DIM = 64


class RWKVState(NamedTuple):
    shift_tm: Tensor   # (layers, B, d) last token's input to time-mix
    shift_cm: Tensor   # (layers, B, d) last token's input to channel-mix
    wkv: Tensor        # (layers, B, H, dk, dv) recurrence state, f32
    index: Tensor      # scalar or (B,) int32 position


def _layer_init(generator: torch.Generator, cfg: ModelConfig) -> dict:
    """One layer's f32 params on the generator's device."""
    d, ff = cfg.d_model, cfg.d_ff
    H = d // HEAD_DIM
    full = lambda shape, value: torch.full(shape, value, dtype=torch.float32,  # noqa: E731
                                           device=generator.device)
    return {
        "tm": {
            "mu": full((5, d), 0.5),                     # r, k, v, w, g mixes
            "w0": full((d,), -6.0),                      # decay bias (slow)
            "w_lora_a": dense_init(generator, d, LORA_DIM, scale=0.01),
            "w_lora_b": dense_init(generator, LORA_DIM, d, scale=0.01),
            "u": full((H, HEAD_DIM), 0.0),               # bonus
            "wr": dense_init(generator, d, d),
            "wk": dense_init(generator, d, d),
            "wv": dense_init(generator, d, d),
            "wg": dense_init(generator, d, d),
            "wo": dense_init(generator, d, d),
            "ln_x": full((H, HEAD_DIM), 1.0),
        },
        "cm": {
            "mu": full((2, d), 0.5),                     # k, r mixes
            "wk": dense_init(generator, d, ff),
            "wv": dense_init(generator, ff, d),
            "wr": dense_init(generator, d, d),
        },
        "norm1": full((d,), 1.0),
        "norm2": full((d,), 1.0),
    }


def init_rwkv_params(generator: torch.Generator, cfg: ModelConfig, device="cuda") -> dict:
    """Random params in the reference's tree layout, built layer by layer on
    ``device`` (the generator's), cast by ``cast_params``' rule as they are
    stacked: only the 1-D ``final_norm`` stays f32, so ``tm.w0``, ``tm.u``,
    ``tm.mu``, ``tm.ln_x`` and the per-layer norms take ``cfg.dtype``."""
    dev = generator_device(generator, device)
    dtype = getattr(torch, cfg.dtype)
    layers = init_stacked_layers(lambda: _layer_init(generator, cfg), cfg.n_layers,
                                 dtype, dev)
    return {
        "embed": dense_init(generator, cfg.vocab, cfg.d_model, scale=1.0).to(dtype),
        "layers": layers,
        "final_norm": torch.ones((cfg.d_model,), dtype=torch.float32, device=dev),
        "lm_head": dense_init(generator, cfg.d_model, cfg.vocab).to(dtype),
        "flow": cast_params(init_flow_head(generator, cfg), dtype),
    }


_LAYER_KEYS = {"tm", "cm", "norm1", "norm2"}


def params_from_jax(tree: dict, cfg: ModelConfig, device="cuda", dtype=None) -> dict:
    """The port's params from the reference's RWKV6 tree, already numpy
    (``jax.tree.map(np.asarray, params)``): the same layout, transferred."""
    if set(tree.get("layers", {})) != _LAYER_KEYS:
        raise ValueError(f"layer tree has {sorted(tree.get('layers', {}))}, "
                         f"expected {sorted(_LAYER_KEYS)}")
    return transfer_params(tree, {"embed", "layers", "final_norm", "lm_head", "flow"},
                           device, dtype)


def _decay(p: dict, m_w: Tensor) -> Tensor:
    """Data-dependent log-decay: ld = -exp(w0 + lora(m_w)) <= 0, in f32."""
    lora = torch.tanh(m_w @ p["w_lora_a"]) @ p["w_lora_b"]
    return -torch.exp(p["w0"].to(torch.float32) + lora.to(torch.float32))


def _mixes(p: dict, x: Tensor, xx: Tensor) -> tuple[Tensor, ...]:
    """The five token-shift mixes x + (x_prev - x) * mu_i (r, k, v, w, g)."""
    return tuple(x + xx * p["mu"][i] for i in range(5))


def _time_mix_seq(p: dict, x: Tensor, shift_in: Tensor, chunk: int
                  ) -> tuple[Tensor, Tensor, Tensor]:
    """x: (B, L, d). Returns (out, last x, final wkv state)."""
    B, L, d = x.shape
    H = d // HEAD_DIM
    x_prev = torch.cat([shift_in[:, None, :], x[:, :-1, :]], dim=1)
    m_r, m_k, m_v, m_w, m_g = _mixes(p, x, x_prev - x)
    r = (m_r @ p["wr"]).reshape(B, L, H, HEAD_DIM)
    k = (m_k @ p["wk"]).reshape(B, L, H, HEAD_DIM)
    v = (m_v @ p["wv"]).reshape(B, L, H, HEAD_DIM)
    g = F.silu(m_g @ p["wg"])
    ld = _decay(p, m_w).reshape(B, L, H, HEAD_DIM)
    o_hist, S = gla_ops.gla(r, k, v, ld, inclusive=False, chunk=chunk)
    bonus = torch.sum(r * p["u"] * k, dim=-1, keepdim=True) * v
    o = rms_norm(o_hist + bonus.to(o_hist.dtype), p["ln_x"]).reshape(B, L, d)
    return (o * g) @ p["wo"], x[:, -1, :], S


def _time_mix_step(p: dict, x: Tensor, shift_in: Tensor, S: Tensor
                   ) -> tuple[Tensor, Tensor, Tensor]:
    """x: (B, d), one token. Returns (out, x, new wkv state)."""
    B, d = x.shape
    H = d // HEAD_DIM
    m_r, m_k, m_v, m_w, m_g = _mixes(p, x, shift_in - x)
    r = (m_r @ p["wr"]).reshape(B, H, HEAD_DIM)
    k = (m_k @ p["wk"]).reshape(B, H, HEAD_DIM)
    v = (m_v @ p["wv"]).reshape(B, H, HEAD_DIM)
    g = F.silu(m_g @ p["wg"])
    ld = _decay(p, m_w).reshape(B, H, HEAD_DIM)
    o_hist, S = gla_step(r, k, v, ld, S, inclusive=False)
    bonus = torch.sum(r * p["u"] * k, dim=-1, keepdim=True) * v
    o = rms_norm(o_hist + bonus.to(o_hist.dtype), p["ln_x"]).reshape(B, d)
    return (o * g) @ p["wo"], x, S


def _channel_mix(p: dict, x: Tensor, x_prev: Tensor) -> Tensor:
    """(B, L, d) with the shifted x_prev, or (B, d) for one step."""
    xx = x_prev - x
    m_k = x + xx * p["mu"][0]
    m_r = x + xx * p["mu"][1]
    k = torch.square(F.relu(m_k @ p["wk"]))
    return torch.sigmoid(m_r @ p["wr"]) * (k @ p["wv"])


def _seq_layer(p: dict, cfg: ModelConfig, h: Tensor, zero: Tensor, chunk: int) -> Tensor:
    tm_out, _, _ = _time_mix_seq(p["tm"], rms_norm(h, p["norm1"], cfg.norm_eps),
                                 zero, chunk)
    h = h + tm_out
    hn = rms_norm(h, p["norm2"], cfg.norm_eps)
    hn_prev = torch.cat([zero[:, None], hn[:, :-1]], dim=1)
    return h + _channel_mix(p["cm"], hn, hn_prev)


def rwkv_hidden(params: dict, cfg: ModelConfig, h: Tensor, positions=None, *,
                chunk: int = 0, remat: bool = False) -> Tensor:
    """Full-sequence forward (flow): h (B, L, d) -> final-normed hidden.
    ``remat`` recomputes each layer in the backward, as ``dense_hidden``'s."""
    chunk = chunk or (cfg.ssm.chunk if cfg.ssm else 64)
    B, L, d = h.shape
    zero = torch.zeros((B, d), dtype=h.dtype, device=h.device)
    for p in layer_views(params["layers"])[:cfg.n_layers]:
        if remat:
            h = checkpoint(_seq_layer, p, cfg, h, zero, chunk, use_reentrant=False)
        else:
            h = _seq_layer(p, cfg, h, zero, chunk)
    return rms_norm(h, params["final_norm"], cfg.norm_eps)


def init_state(cfg: ModelConfig, batch: int, device="cuda") -> RWKVState:
    """Zeroed f32 decode state and a scalar index (the reference's default)."""
    dev = resolve_device(device)
    H, L = cfg.d_model // HEAD_DIM, cfg.n_layers
    zeros = lambda shape, dtype=torch.float32: torch.zeros(  # noqa: E731
        shape, dtype=dtype, device=dev)
    return RWKVState(shift_tm=zeros((L, batch, cfg.d_model)),
                     shift_cm=zeros((L, batch, cfg.d_model)),
                     wkv=zeros((L, batch, H, HEAD_DIM, HEAD_DIM)),
                     index=zeros((), torch.int32))


def decode_step(params: dict, cfg: ModelConfig, token: Tensor, state: RWKVState, *,
                active: Optional[Tensor] = None) -> tuple[Tensor, RWKVState]:
    """One-token decode: token (B,) -> (logits (B, V), state).

    ``state`` is updated IN PLACE: ``shift_tm``, ``shift_cm`` and ``wkv`` in
    the rows where ``active`` (B,) bool is True (all rows when None); the
    other rows keep every bit. The index advances in place too (only the
    active rows' when ``active`` is given), and ``state`` is returned."""
    h = params["embed"][token.long()]                                # (B, d)
    keep = None if active is None else active.to(torch.bool)

    def write(leaf: Tensor, new: Tensor) -> None:
        if keep is None:
            leaf.copy_(new)
        else:
            leaf.copy_(torch.where(keep.reshape((-1,) + (1,) * (leaf.dim() - 1)),
                                   new.to(leaf.dtype), leaf))

    for i, p in enumerate(layer_views(params["layers"])[:cfg.n_layers]):
        hn = rms_norm(h, p["norm1"], cfg.norm_eps)
        tm_out, sh_tm, S = _time_mix_step(p["tm"], hn, state.shift_tm[i].to(hn.dtype),
                                          state.wkv[i])
        h = h + tm_out
        hn2 = rms_norm(h, p["norm2"], cfg.norm_eps)
        h = h + _channel_mix(p["cm"], hn2, state.shift_cm[i].to(hn2.dtype))
        write(state.shift_tm[i], sh_tm)
        write(state.shift_cm[i], hn2)
        write(state.wkv[i], S)
    logits = rms_norm(h, params["final_norm"], cfg.norm_eps) @ params["lm_head"]
    index = state.index + 1
    if keep is not None:
        index = torch.where(keep, index, state.index)
    state.index.copy_(index)
    return logits, state
