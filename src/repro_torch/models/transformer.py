"""Dense decoder-only transformer family (llama-style GQA), flow head.

Port of the flow path of ``repro.models.transformer`` (yi-6b / yi-34b
[arXiv:2403.04652], phi3-medium-14b, command-r-35b's parallel block).

Layer params are stacked on a leading axis, as in the reference, and the
forward pass is a Python loop over that axis where the reference scans. The
LM head is created so that ``params_from_jax`` covers the whole tree; it and
``decode_step`` are not on the flow path (ROADMAP Queue A item 9).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import attention_forward, init_attention
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
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, params on {dev}")
    dtype = getattr(torch, cfg.dtype)
    layers = None
    for i in range(cfg.n_layers):
        layer = _layer_init(generator, cfg)
        if layers is None:
            layers = _tree_map(lambda x: torch.empty(
                (cfg.n_layers,) + tuple(x.shape), dtype=dtype, device=dev), layer)
        _copy_layer(layers, layer, i)
        del layer
    params = {
        "embed": dense_init(generator, cfg.vocab, cfg.d_model, scale=1.0).to(dtype),
        "layers": layers,
        "final_norm": torch.ones((cfg.d_model,), dtype=torch.float32, device=dev),
        "flow": cast_params(init_flow_head(generator, cfg), dtype),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(generator, cfg.d_model, cfg.vocab).to(dtype)
    return params


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
    dev = resolve_device(device)
    expected = {"embed", "layers", "final_norm", "flow"}
    if not cfg.tie_embeddings:
        expected.add("lm_head")
    if set(tree) != expected:
        raise ValueError(f"param tree has {sorted(tree)}, expected {sorted(expected)}")
    out = _tree_map(lambda a: _from_numpy(np.asarray(a)).to(dev), tree)
    return cast_params(out, dtype) if dtype is not None else out


def _layer(layers: dict, i: int) -> dict:
    return _tree_map(lambda x: x[i], layers)


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
                 *, causal: bool = True, window: int = 0) -> Tensor:
    for i in range(cfg.n_layers):
        h = _block(_layer(params["layers"], i), cfg, h, positions, causal, window)
    return rms_norm(h, params["final_norm"], cfg.norm_eps)


# ---------------------------------------------------------------------------
# Flow mode — the backbone as a velocity field u_t(x) (paper substrate)
# ---------------------------------------------------------------------------


def flow_velocity(params: dict, cfg: ModelConfig, t, x: Tensor,
                  cond_tokens: Optional[Tensor]) -> Tensor:
    """u_t(x): x (B, S, latent_dim) noisy latents -> velocity, same shape and dtype.

    Conditioning: token embeddings added to the input projection;
    ``cond_tokens=None`` is the unconditional branch (CFG). ``t`` is a scalar
    or (B,); the flow path runs ``dense_hidden`` without a window, so its
    attention is plain causal attention.
    """
    f = params["flow"]
    h = x.to(f["proj_in"].dtype) @ f["proj_in"]
    if cond_tokens is not None:
        h = h + params["embed"][cond_tokens]
    temb = timestep_embedding(t, cfg.d_model, device=x.device).to(h.dtype)
    temb = F.silu(temb @ f["time_w1"]) @ f["time_w2"]
    h = h + temb[:, None, :]
    h = dense_hidden(params, cfg, h, torch.arange(x.shape[1], device=x.device),
                     causal=True)
    return (h @ f["proj_out"]).to(x.dtype)


def latent_targets(params: dict, tokens: Tensor) -> Tensor:
    """x1 = latent embedding of the data tokens (flow-matching target)."""
    return params["flow"]["latent_embed"][tokens]
