"""Dense decoder-only transformer family (llama-style GQA): flow head and
one-token decode.

Port of ``repro.models.transformer`` (yi-6b / yi-34b [arXiv:2403.04652],
phi3-medium-14b, command-r-35b's parallel block): the flow path, and
``decode_step`` over a dense or paged KV cache.

Layer params and caches are stacked on a leading axis, as in the reference,
and every pass is a Python loop over that axis where the reference scans.
``lm_forward`` (training and full-sequence prefill) is not ported: serving
prefills token by token through ``decode_step``, as the reference's gateway
does.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import (
    KVCache,
    PagedKVCache,
    attention_forward,
    decode_attention,
    decode_attention_paged,
    init_attention,
)
from repro_torch.models.layers import dense_init, rms_norm, swiglu, timestep_embedding

Tensor = torch.Tensor


def _layer_init(generator: torch.Generator, cfg: ModelConfig) -> dict:
    """One layer's f32 params on the generator's device."""
    hd = cfg.resolved_head_dim
    ones = lambda: torch.ones((cfg.d_model,), dtype=torch.float32,  # noqa: E731
                              device=generator.device)
    p = {
        "attn": init_attention(generator, cfg.d_model, cfg.n_heads,
                               cfg.n_kv_heads, hd, cfg.qk_norm),
        "mlp": {
            "w_gate": dense_init(generator, cfg.d_model, cfg.d_ff),
            "w_up": dense_init(generator, cfg.d_model, cfg.d_ff),
            "w_down": dense_init(generator, cfg.d_ff, cfg.d_model),
        },
        "norm1": ones(),
    }
    if not cfg.parallel_block:
        p["norm2"] = ones()
    return p


def init_flow_head(generator: torch.Generator, cfg: ModelConfig) -> dict:
    return {
        "latent_embed": dense_init(generator, cfg.vocab, cfg.latent_dim, scale=1.0),
        "proj_in": dense_init(generator, cfg.latent_dim, cfg.d_model),
        "proj_out": dense_init(generator, cfg.d_model, cfg.latent_dim),
        "time_w1": dense_init(generator, cfg.d_model, cfg.d_model),
        "time_w2": dense_init(generator, cfg.d_model, cfg.d_model),
    }


def cast_params(params, dtype: torch.dtype):
    """Cast matmul weights; keep 1-D tensors (the final norm scale) in f32.

    As in the reference, the rule looks at the stacked leaf, so the per-layer
    norm scales, stacked to (n_layers, d), take ``dtype`` too.
    """
    return _tree_map(lambda x: x if x.dim() == 1 else x.to(dtype), params)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def init_dense_params(generator: torch.Generator, cfg: ModelConfig,
                      device="cuda") -> dict:
    """Random params in the reference's tree layout, built tensor by tensor on
    ``device`` (which must be the generator's): each matrix is a normal draw
    in f32, scaled, then cast, as ``dense_init`` + ``cast_params`` do, so no
    f32 copy of the whole tree ever exists."""
    dev = generator_device(generator, device)
    dtype = getattr(torch, cfg.dtype)
    layers = init_stacked_layers(lambda: _layer_init(generator, cfg), cfg.n_layers,
                                 dtype, dev)
    params = {
        "embed": dense_init(generator, cfg.vocab, cfg.d_model, scale=1.0).to(dtype),
        "layers": layers,
        "final_norm": torch.ones((cfg.d_model,), dtype=torch.float32, device=dev),
        "flow": cast_params(init_flow_head(generator, cfg), dtype),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(generator, cfg.d_model, cfg.vocab).to(dtype)
    return params


def generator_device(generator: torch.Generator, device) -> torch.device:
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, params on {dev}")
    return dev


def init_stacked_layers(layer_init, n_layers: int, dtype: torch.dtype,
                        device) -> dict:
    """``n_layers`` draws of ``layer_init()`` (one layer's f32 tree), stacked on
    a leading axis in ``dtype`` one layer at a time. Every stacked leaf is at
    least 2-D, so ``cast_params``' rule gives them all ``dtype``."""
    layers = None
    for i in range(n_layers):
        layer = layer_init()
        if layers is None:
            layers = _tree_map(lambda x: torch.empty(
                (n_layers,) + tuple(x.shape), dtype=dtype, device=device), layer)
        _copy_layer(layers, layer, i)
        del layer
    return layers


def _copy_layer(stacked: dict, layer: dict, i: int) -> None:
    for k, v in layer.items():
        if isinstance(v, dict):
            _copy_layer(stacked[k], v, i)
        else:
            stacked[k][i].copy_(v)


def params_to(params, device) -> dict:
    """The same tree on another device."""
    return _tree_map(lambda x: x.to(device), params)


def _from_numpy(arr: np.ndarray) -> Tensor:
    arr = np.array(arr)                # a writable copy: JAX exports read-only views
    if arr.dtype.name == "bfloat16":   # ml_dtypes' bfloat16, as JAX exports it
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def params_from_jax(tree: dict, cfg: ModelConfig, device="cuda", dtype=None) -> dict:
    """The port's params from the reference's param tree, already numpy
    (``jax.tree.map(np.asarray, params)``).

    The layouts agree, so this is a transfer, not a re-layout. With
    ``dtype`` given, leaves are cast by ``cast_params``' rule; otherwise they
    keep the reference's dtypes.
    """
    expected = {"embed", "layers", "final_norm", "flow"}
    if not cfg.tie_embeddings:
        expected.add("lm_head")
    return transfer_params(tree, expected, device, dtype)


def transfer_params(tree: dict, expected: set, device="cuda", dtype=None) -> dict:
    """A numpy param tree whose top-level keys must be ``expected``, as
    tensors on ``device`` (cast by ``cast_params``' rule when ``dtype`` is given)."""
    dev = resolve_device(device)
    if set(tree) != expected:
        raise ValueError(f"param tree has {sorted(tree)}, expected {sorted(expected)}")
    out = _tree_map(lambda a: _from_numpy(np.asarray(a)).to(dev), tree)
    return cast_params(out, dtype) if dtype is not None else out


def layer_views(layers: dict) -> list[dict]:
    """Each layer's tree of a stacked tree: ``x[i]`` of every leaf, whether
    the leaf is the stacked tensor or the tuple of its layers' views
    (``model.unbind_layers``, the trainer's form, whose gradient is then
    each layer's own tensor)."""
    first = layers
    while isinstance(first, dict):
        first = next(iter(first.values()))
    return [_tree_map(lambda x: x[i], layers) for i in range(len(first))]


def _block(p: dict, cfg: ModelConfig, h: Tensor, positions: Tensor,
           causal: bool, window: int) -> Tensor:
    hd = cfg.resolved_head_dim
    attn_kw = dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=hd,
                   rope_theta=cfg.rope_theta, causal=causal, window=window,
                   norm_eps=cfg.norm_eps)
    if cfg.parallel_block:
        hn = rms_norm(h, p["norm1"], cfg.norm_eps)
        return h + attention_forward(p["attn"], hn, positions, **attn_kw) \
                 + swiglu(hn, **p["mlp"])
    h = h + attention_forward(p["attn"], rms_norm(h, p["norm1"], cfg.norm_eps),
                              positions, **attn_kw)
    h = h + swiglu(rms_norm(h, p["norm2"], cfg.norm_eps), **p["mlp"])
    return h


def dense_hidden(params: dict, cfg: ModelConfig, h: Tensor, positions: Tensor,
                 *, causal: bool = True, window: int = 0,
                 remat: bool = False) -> Tensor:
    """The layer stack and the final norm. ``remat`` recomputes each layer
    in the backward instead of keeping its activations (the reference's
    ``jax.checkpoint`` around the scan body): only each layer's input is
    saved, and the layer runs twice under grad."""
    for p in layer_views(params["layers"])[:cfg.n_layers]:
        if remat:
            h = checkpoint(_block, p, cfg, h, positions, causal, window,
                           use_reentrant=False)
        else:
            h = _block(p, cfg, h, positions, causal, window)
    return rms_norm(h, params["final_norm"], cfg.norm_eps)


def init_caches(cfg: ModelConfig, batch: int, slots: int, dtype=torch.bfloat16,
                device="cuda") -> KVCache:
    """Zeroed dense caches, (L, batch, slots, KV, hd), and a scalar index."""
    shape = (cfg.n_layers, batch, slots, cfg.n_kv_heads, cfg.resolved_head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   index=torch.zeros((), dtype=torch.int32, device=device))


def init_paged_caches(cfg: ModelConfig, batch: int, num_pages: int, page_size: int,
                      blocks_per_slot: int, dtype=torch.bfloat16,
                      device="cuda") -> PagedKVCache:
    """Paged decode state: a shared (L, num_pages, page_size, KV, hd) pool plus
    a zeroed per-row block table — every row starts on the reserved trash
    page 0 until the gateway's page allocator assigns it pages."""
    shape = (cfg.n_layers, num_pages, page_size, cfg.n_kv_heads, cfg.resolved_head_dim)
    return PagedKVCache(
        k_pages=torch.zeros(shape, dtype=dtype, device=device),
        v_pages=torch.zeros(shape, dtype=dtype, device=device),
        block_table=torch.zeros((batch, blocks_per_slot), dtype=torch.int32, device=device),
        index=torch.zeros((batch,), dtype=torch.int32, device=device))


def decode_step(params: dict, cfg: ModelConfig, token: Tensor, caches, *,
                window: int = 0, paged_kernel: bool = False,
                active: Optional[Tensor] = None, mlp=None):
    """One-token decode: token (B,) -> (logits (B, V), caches).

    ``caches`` is a dense ``KVCache`` or a ``PagedKVCache``, updated IN PLACE
    (see ``models.attention``), its index tensor too, and returned (a CUDA
    graph of the step holds every leaf by address).
    ``active`` (B,) bool picks the rows the step advances (None: all): the
    other rows keep their position and, in a dense cache, every bit of their
    cache rows. A paged pool is written unconditionally, as the reference's
    is. ``paged_kernel`` routes paged attention through the CUDA kernel.
    ``mlp(layer_params, x)`` is the layer's feed-forward (None: the dense
    SwiGLU of ``layer_params["mlp"]``; the MoE family passes its router).
    """
    if mlp is None:
        mlp = lambda p, x: swiglu(x, **p["mlp"])                # noqa: E731
    h = params["embed"][token.long()][:, None, :]              # (B, 1, d)
    B = h.shape[0]
    paged = isinstance(caches, PagedKVCache)
    attn_kw = dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.resolved_head_dim,
                   rope_theta=cfg.rope_theta, norm_eps=cfg.norm_eps)
    pos = caches.index.to(torch.int32).expand(B)
    for i, p in enumerate(layer_views(params["layers"])[:cfg.n_layers]):
        hn = rms_norm(h, p["norm1"], cfg.norm_eps)
        if paged:
            attn_out = decode_attention_paged(
                p["attn"], hn, caches.k_pages[i], caches.v_pages[i], caches.block_table,
                pos, kernel=paged_kernel, **attn_kw)
        else:
            layer_cache = KVCache(k=caches.k[i], v=caches.v[i], index=caches.index)
            attn_out, _ = decode_attention(p["attn"], hn, layer_cache, window=window,
                                           active=active, **attn_kw)
        if cfg.parallel_block:
            h = h + attn_out + mlp(p, hn)
        else:
            h = h + attn_out
            h = h + mlp(p, rms_norm(h, p["norm2"], cfg.norm_eps))
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)[:, 0, :]
    logits = h @ (params["embed"].T if cfg.tie_embeddings else params["lm_head"])
    index = pos + 1
    if active is not None:
        index = torch.where(active, index, pos)
    elif caches.index.dim() == 0:
        index = caches.index + 1
    caches.index.copy_(index)
    return logits, caches


# ---------------------------------------------------------------------------
# Flow mode — the backbone as a velocity field u_t(x) (paper substrate)
# ---------------------------------------------------------------------------


def flow_velocity(params: dict, cfg: ModelConfig, t, x: Tensor,
                  cond_tokens: Optional[Tensor], *, hidden_fn=None) -> Tensor:
    """u_t(x): x (B, S, latent_dim) noisy latents -> velocity, same shape and dtype.

    Conditioning: token embeddings added to the input projection;
    ``cond_tokens=None`` is the unconditional branch (CFG). ``t`` is a scalar
    or (B,). ``hidden_fn(params, cfg, h, positions)`` lets non-dense families
    reuse this head; by default the flow path runs ``dense_hidden`` without a
    window, so its attention is plain causal attention.
    """
    f = params["flow"]
    h = x.to(f["proj_in"].dtype) @ f["proj_in"]
    if cond_tokens is not None:
        h = h + params["embed"][cond_tokens]
    temb = timestep_embedding(t, cfg.d_model, device=x.device).to(h.dtype)
    temb = F.silu(temb @ f["time_w1"]) @ f["time_w2"]
    h = h + temb[:, None, :]
    positions = torch.arange(x.shape[1], device=x.device)
    if hidden_fn is None:
        h = dense_hidden(params, cfg, h, positions, causal=True)
    else:
        h = hidden_fn(params, cfg, h, positions)
    return (h @ f["proj_out"]).to(x.dtype)


def latent_targets(params: dict, tokens: Tensor) -> Tensor:
    """x1 = latent embedding of the data tokens (flow-matching target)."""
    return params["flow"]["latent_embed"][tokens]
