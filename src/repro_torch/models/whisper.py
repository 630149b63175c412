"""Whisper-medium encoder-decoder backbone [arXiv:2212.04356].

Port of ``repro.models.whisper``. The mel-spectrogram and conv frontend is a
stub, as in the reference: the batch carries precomputed frame embeddings
(B, num_frames, d_model) under ``"frames"``. The encoder (bidirectional
self-attention with RoPE over frame positions) and the decoder (causal
self-attention, cross-attention over the encoder memory, a tanh-GELU MLP)
are the reference's, with its pre-norm RMSNorm and RoPE where Whisper has
LayerNorm and learned positions. On the card every attention runs the flash
kernel at head dim 64: the encoder non-causal over the frames, the
decoder's self-attention causal, its cross-attention non-causal with
Lq != Lk (Lq = 1 in decode). Layer stacks are Python loops where the
reference scans.

The bf16 rule. At a bf16 config the reference raises: its f32 frames meet
bf16 weights, so JAX promotes the encoder's memory to f32, cross-attention
promotes the decoder's bf16 state to f32, and ``decoder_hidden``'s scan
refuses a carry whose dtype changed (``greedy_demo`` and a decode step over
an encoded memory fail the same way, their memory being f32). The port
casts where JAX promotes: the frames to the encoder weights' dtype at
``encode``'s entry, and the memory to the decoder state's dtype inside
``attention.cross_attention_forward``. At f32 both casts are no-ops, so the
port equals the reference there; at bf16 it runs in bf16 throughout.

``decode_step`` updates its ``EncDecState`` in place (the self-attention
caches and the index; the memory is read), as ``transformer.decode_step``
does, so a graphed step holds every leaf by address. ``lm_forward`` encodes
the frames and gives the decoder's full-sequence logits (tied embeddings).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import context
from repro_torch.models.attention import (
    KVCache,
    attention_forward,
    cross_attention_forward,
    decode_attention,
    init_attention,
)
from repro_torch.models.layers import dense_init, embed, rms_norm
from repro_torch.models.transformer import (
    cast_params,
    generator_device,
    init_flow_head,
    init_stacked_layers,
    layer_views,
    transfer_params,
)

Tensor = torch.Tensor


class EncDecState(NamedTuple):
    k: Tensor        # (L, B, slots, KV, hd) decoder self-attention keys
    v: Tensor
    memory: Tensor   # (B, M, d) encoded audio (written once, before decoding)
    index: Tensor    # int32 scalar: tokens already decoded


def _mlp_init(generator: torch.Generator, d: int, ff: int) -> dict:
    return {"w1": dense_init(generator, d, ff), "w2": dense_init(generator, ff, d)}


def _mlp(p: dict, x: Tensor) -> Tensor:
    # jax.nn.gelu's default is the tanh approximation; torch's is the erf form
    hidden = context.pin_batch(F.gelu(x @ p["w1"], approximate="tanh"), model_last=True)
    return context.pin_batch(hidden @ p["w2"])


def _ones(cfg: ModelConfig, device) -> Tensor:
    return torch.ones((cfg.d_model,), dtype=torch.float32, device=device)


def _enc_layer_init(generator: torch.Generator, cfg: ModelConfig) -> dict:
    """One encoder layer's f32 params on the generator's device."""
    hd = cfg.resolved_head_dim
    return {
        "attn": init_attention(generator, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, hd),
        "mlp": _mlp_init(generator, cfg.d_model, cfg.d_ff),
        "norm1": _ones(cfg, generator.device),
        "norm2": _ones(cfg, generator.device),
    }


def _dec_layer_init(generator: torch.Generator, cfg: ModelConfig) -> dict:
    """One decoder layer's f32 params; cross-attention has a KV head a query head."""
    hd = cfg.resolved_head_dim
    return {
        "self_attn": init_attention(generator, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, hd),
        "cross_attn": init_attention(generator, cfg.d_model, cfg.n_heads, cfg.n_heads, hd),
        "mlp": _mlp_init(generator, cfg.d_model, cfg.d_ff),
        "norm1": _ones(cfg, generator.device),
        "norm2": _ones(cfg, generator.device),
        "norm3": _ones(cfg, generator.device),
    }


def init_encdec_params(generator: torch.Generator, cfg: ModelConfig,
                       device="cuda") -> dict:
    """Random params in the reference's tree layout (the LM head tied to
    ``embed``), drawn in f32 one layer at a time and cast, as
    ``transformer.init_dense_params`` does."""
    dev = generator_device(generator, device)
    dtype = getattr(torch, cfg.dtype)
    n_enc = cfg.n_encoder_layers or cfg.n_layers
    return {
        "embed": dense_init(generator, cfg.vocab, cfg.d_model, scale=1.0).to(dtype),
        "enc_layers": init_stacked_layers(lambda: _enc_layer_init(generator, cfg), n_enc,
                                          dtype, dev),
        "dec_layers": init_stacked_layers(lambda: _dec_layer_init(generator, cfg),
                                          cfg.n_layers, dtype, dev),
        "enc_norm": _ones(cfg, dev),
        "final_norm": _ones(cfg, dev),
        "flow": cast_params(init_flow_head(generator, cfg), dtype),
    }


def params_from_jax(tree: dict, cfg: ModelConfig, device="cuda", dtype=None) -> dict:
    """The port's params from the reference's numpy param tree (the layouts
    agree; ``transformer.params_from_jax``)."""
    return transfer_params(tree, {"embed", "enc_layers", "dec_layers", "enc_norm",
                                  "final_norm", "flow"}, device, dtype)


def _enc_block(p: dict, cfg: ModelConfig, h: Tensor, positions: Tensor) -> Tensor:
    hd = cfg.resolved_head_dim
    h = h + attention_forward(p["attn"], rms_norm(h, p["norm1"], cfg.norm_eps), positions,
                              n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=hd,
                              rope_theta=cfg.rope_theta, causal=False,
                              norm_eps=cfg.norm_eps)
    return h + _mlp(p["mlp"], rms_norm(h, p["norm2"], cfg.norm_eps))


def encode(params: dict, cfg: ModelConfig, frames: Tensor, remat: bool = False) -> Tensor:
    """frames (B, M, d_model) stub frontend embeddings -> encoder memory, in
    the encoder weights' dtype (the frames are cast to it: the bf16 rule)."""
    layers = layer_views(params["enc_layers"])
    h = frames.to(layers[0]["attn"]["wq"].dtype)
    positions = torch.arange(frames.shape[1], device=frames.device)
    for p in layers:
        if remat:
            h = checkpoint(_enc_block, p, cfg, h, positions, use_reentrant=False)
        else:
            h = _enc_block(p, cfg, h, positions)
    return context.pin_batch(rms_norm(h, params["enc_norm"], cfg.norm_eps))


def _dec_block(p: dict, cfg: ModelConfig, h: Tensor, memory: Tensor, positions: Tensor,
               causal: bool) -> Tensor:
    hd = cfg.resolved_head_dim
    h = h + attention_forward(p["self_attn"], rms_norm(h, p["norm1"], cfg.norm_eps),
                              positions, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                              head_dim=hd, rope_theta=cfg.rope_theta, causal=causal,
                              norm_eps=cfg.norm_eps)
    h = h + cross_attention_forward(p["cross_attn"], rms_norm(h, p["norm2"], cfg.norm_eps),
                                    memory, n_heads=cfg.n_heads, head_dim=hd)
    return h + _mlp(p["mlp"], rms_norm(h, p["norm3"], cfg.norm_eps))


def decoder_hidden(params: dict, cfg: ModelConfig, h: Tensor, memory: Tensor,
                   positions: Optional[Tensor] = None, *, causal: bool = True,
                   remat: bool = False) -> Tensor:
    """The decoder stack over ``h`` (B, S, d) and the final norm."""
    if positions is None:
        positions = torch.arange(h.shape[1], device=h.device)
    for p in layer_views(params["dec_layers"])[:cfg.n_layers]:
        if remat:
            h = checkpoint(_dec_block, p, cfg, h, memory, positions, causal,
                           use_reentrant=False)
        else:
            h = _dec_block(p, cfg, h, memory, positions, causal)
    return rms_norm(h, params["final_norm"], cfg.norm_eps)


def lm_forward(params: dict, cfg: ModelConfig, tokens: Tensor, frames: Tensor,
               positions=None, last_only: bool = False, **_) -> Tensor:
    """Full-sequence logits: ``encode`` the frames, then ``decoder_hidden``
    over the tokens and the projection onto the tied embeddings."""
    memory = encode(params, cfg, frames)
    h = decoder_hidden(params, cfg, embed(params["embed"], tokens), memory, positions)
    if last_only:
        h = h[:, -1:, :]
    return h @ params["embed"].T


def init_state(cfg: ModelConfig, batch: int, slots: int, num_frames: int,
               dtype=torch.bfloat16, device="cuda") -> EncDecState:
    """Zeroed caches and memory; ``decode_step`` reads the memory, which the
    caller writes (``encode``'s output) before decoding."""
    shape = (cfg.n_layers, batch, slots, cfg.n_kv_heads, cfg.resolved_head_dim)
    return EncDecState(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        memory=torch.zeros((batch, num_frames, cfg.d_model), dtype=dtype, device=device),
        index=torch.zeros((), dtype=torch.int32, device=device))


def decode_step(params: dict, cfg: ModelConfig, token: Tensor, state: EncDecState, *,
                active: Optional[Tensor] = None) -> tuple[Tensor, EncDecState]:
    """One-token decode: token (B,) -> (logits (B, V), state), the state's
    caches and index updated IN PLACE (``active`` as in
    ``transformer.decode_step``)."""
    hd = cfg.resolved_head_dim
    h = embed(params["embed"], token)[:, None, :]              # (B, 1, d)
    B = h.shape[0]
    pos = state.index.to(torch.int32).expand(B)
    for i, p in enumerate(layer_views(params["dec_layers"])[:cfg.n_layers]):
        cache = KVCache(k=state.k[i], v=state.v[i], index=state.index)
        attn_out, _ = decode_attention(
            p["self_attn"], rms_norm(h, p["norm1"], cfg.norm_eps), cache,
            n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=hd,
            rope_theta=cfg.rope_theta, norm_eps=cfg.norm_eps, active=active)
        h = h + attn_out
        h = h + cross_attention_forward(p["cross_attn"],
                                        rms_norm(h, p["norm2"], cfg.norm_eps),
                                        state.memory, n_heads=cfg.n_heads, head_dim=hd)
        h = h + _mlp(p["mlp"], rms_norm(h, p["norm3"], cfg.norm_eps))
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)[:, 0]
    logits = h @ params["embed"].T
    index = pos + 1
    if active is not None:
        index = torch.where(active, index, pos)
    elif state.index.dim() == 0:
        index = state.index + 1
    state.index.copy_(index)
    return logits, state
