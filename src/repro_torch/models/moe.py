"""Mixture-of-Experts transformer (qwen3-moe family: 128 experts, top-8)
[hf:Qwen/Qwen3-30B-A3B].

Port of ``repro.models.moe``. Two dispatch strategies, selected by
``MoEConfig.router_impl``, with the reference's semantics:

  * ``scatter`` (the full configs): capacity-based routing per sequence
    (GShard groups). Each (token, choice) finds its position in its expert by
    a cumulative sum over the sequence and so its slot among the E·B·C (the
    reference's (B, E·C + 1, d) buffer, laid out expert-major, with one drop
    slot past the end); the tokens are gathered into the slots, the three
    expert products run on them, and the outputs are gathered back and
    weighted by ``gates * keep``.
  * ``onehot`` (the 30b-a3b smoke config): the GShard/Switch einsum form,
    with the capacity taken over the global batch.

Both drop tokens over capacity C = max(int(group · k · cf / E), k). Every
shape is static and nothing is read on the host (no ``nonzero``, no boolean
indexing, no ``.item()``), so the flow and decode programs capture as CUDA
graphs. The forward sums nothing with atomics: an integer scatter records the
one (token, choice) that fills each kept slot (the discarded drop slot takes
many), and the tokens are gathered through it, so a slot holds its token's
bits and the results do not depend on any order of writes.

The router's top-k is a stable descending sort: among equal probabilities the
lower expert comes first, as ``jax.lax.top_k`` orders them (``torch.topk``
leaves ties unordered), and the order of a token's choices sets its position
in each expert, hence which tokens are dropped.

The expert products are plain batched matmuls (``torch.bmm``), as the
reference leaves them to XLA outside any Pallas kernel. Attention is the
dense family's (``attention_forward``: the flash kernel on the card).
Decode is ``transformer.decode_step`` with this family's feed-forward, over a
dense or paged KV cache. ``lm_forward`` is not ported, as the dense family's
is not: serving prefills through ``decode_step``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer
from repro_torch.models.attention import attention_forward, init_attention
from repro_torch.models.layers import dense_init, rms_norm
from repro_torch.models.transformer import (
    cast_params,
    generator_device,
    init_flow_head,
    init_stacked_layers,
    layer_views,
    transfer_params,
)

Tensor = torch.Tensor


def _normal(generator: torch.Generator, shape: tuple, scale: float) -> Tensor:
    return torch.randn(shape, generator=generator, dtype=torch.float32,
                       device=generator.device).mul_(scale)


def init_moe_mlp(generator: torch.Generator, cfg: ModelConfig) -> dict:
    """One layer's router and experts, f32, on the generator's device."""
    m, d = cfg.moe, cfg.d_model
    return {
        "router": dense_init(generator, d, m.num_experts),
        "w_gate": _normal(generator, (m.num_experts, d, m.d_expert), d ** -0.5),
        "w_up": _normal(generator, (m.num_experts, d, m.d_expert), d ** -0.5),
        "w_down": _normal(generator, (m.num_experts, m.d_expert, d), m.d_expert ** -0.5),
    }


def _routing(p: dict, x2d: Tensor, cfg: ModelConfig):
    """x2d: (T, d) -> (gates (T, k) in x's dtype, expert_idx (T, k), aux_loss).

    Router logits in f32 on an f32 copy of x; softmax, the top k by a stable
    descending sort (ties to the lower expert), gates renormalised; the
    Switch load-balance loss from the first choices."""
    m = cfg.moe
    logits = x2d.to(torch.float32) @ p["router"].to(torch.float32)
    probs = torch.softmax(logits, dim=-1)                          # (T, E)
    ranked, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = ranked[:, :m.top_k], order[:, :m.top_k]          # (T, k)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    density = F.one_hot(idx[:, 0], m.num_experts).to(torch.float32).mean(0)
    density_proxy = probs.mean(0)
    aux = m.num_experts * torch.sum(density * density_proxy)
    return gates.to(x2d.dtype), idx, aux


def _capacity(T: int, cfg: ModelConfig) -> int:
    m = cfg.moe
    return max(int(T * m.top_k * m.capacity_factor / m.num_experts), m.top_k)


def _experts(p: dict, xin: Tensor) -> Tensor:
    """The SwiGLU of each expert over its slots: (E, N, d) -> (E, N, d)."""
    h = F.silu(torch.bmm(xin, p["w_gate"])) * torch.bmm(xin, p["w_up"])
    return torch.bmm(h, p["w_down"])


def moe_mlp_scatter(p: dict, x: Tensor, cfg: ModelConfig):
    """(B, S, d) -> ((B, S, d), aux). Scatter/gather dispatch with one group
    a sequence: capacity and each choice's position in its expert are
    computed within the sequence, so a row's result does not depend on the
    other rows of the batch. The slots are laid out expert-major, (E, B, C),
    so the expert products read them in place."""
    m = cfg.moe
    B, S, d = x.shape
    E, k = m.num_experts, m.top_k
    C = _capacity(S, cfg)
    gates, idx, aux = _routing(p, x.reshape(B * S, d), cfg)
    gates, idx = gates.reshape(B, S * k), idx.reshape(B, S * k)

    # position of each (token, choice) inside its expert, within the sequence:
    # a running count a expert, laid out (B, E, S*k) so the scan runs along
    # memory (a scan over the middle axis of (B, S*k, E) took ~2.8 ms a layer
    # at the flow shape, scripts/moe_dispatch_profile.py)
    hits = (idx[:, None, :] == torch.arange(E, device=x.device)[:, None]).to(torch.int32)
    before = torch.cumsum(hits, dim=2, dtype=torch.int32) - hits
    pos_in_e = before.gather(1, idx[:, None, :])[:, 0].long()        # (B, S*k)
    keep = pos_in_e < C
    rows = torch.arange(B, device=x.device)[:, None]
    slot = torch.where(keep, (idx * B + rows) * C + pos_in_e, E * B * C)   # E*B*C: drop
    slot = slot.reshape(B * S * k)

    # which token fills each slot (B*S, a zero row, where none does): one
    # writer a kept slot, so no sums; the drop slot's many writes are discarded
    fill = torch.full((E * B * C + 1,), B * S, dtype=torch.long, device=x.device)
    fill.scatter_(0, slot, torch.arange(B * S * k, device=x.device) // k)
    zero = torch.zeros((1, d), dtype=x.dtype, device=x.device)
    xin = torch.cat([x.reshape(B * S, d), zero]).index_select(0, fill[:-1])
    out = _experts(p, xin.reshape(E, B * C, d)).reshape(E * B * C, d)

    picked = torch.cat([out, zero]).index_select(0, slot).reshape(B, S, k, d)
    weight = (gates * keep).reshape(B, S, k, 1)
    return torch.sum(picked * weight, dim=2), aux


def moe_mlp_onehot(p: dict, x: Tensor, cfg: ModelConfig):
    """The GShard-style einsum dispatch, capacity over the global batch
    (small shapes only: it builds (T, k, E, C) tensors)."""
    m = cfg.moe
    B, S, d = x.shape
    T = B * S
    C = _capacity(T, cfg)
    x2d = x.reshape(T, d)
    gates, idx, aux = _routing(p, x2d, cfg)

    onehot = F.one_hot(idx, m.num_experts).to(torch.float32)          # (T, k, E)
    pos = torch.cumsum(onehot.reshape(T * m.top_k, -1), dim=0).reshape(
        T, m.top_k, m.num_experts) * onehot - 1.0
    keep = (pos < C) & (pos >= 0)
    slots = torch.arange(C, dtype=torch.float32, device=x.device)
    cap_onehot = (pos[..., None] == slots).to(torch.float32) * keep[..., None]
    dispatch = torch.einsum("tke,tkec->tec", onehot, cap_onehot)     # (T, E, C)
    combine = torch.einsum("tk,tke,tkec->tec", gates.to(torch.float32), onehot,
                           cap_onehot)

    expert_in = torch.einsum("tec,td->ecd", dispatch.to(x.dtype), x2d)
    expert_out = _experts(p, expert_in)
    out = torch.einsum("tec,ecd->td", combine.to(x.dtype), expert_out)
    return out.reshape(B, S, d), aux


def moe_mlp(p: dict, x: Tensor, cfg: ModelConfig):
    impl = cfg.moe.router_impl
    return (moe_mlp_scatter if impl == "scatter" else moe_mlp_onehot)(p, x, cfg)


# ---------------------------------------------------------------------------
# Full MoE model (attention blocks shared with the dense family)
# ---------------------------------------------------------------------------


def _layer_init(generator: torch.Generator, cfg: ModelConfig) -> dict:
    ones = lambda: torch.ones((cfg.d_model,), dtype=torch.float32,  # noqa: E731
                              device=generator.device)
    return {
        "attn": init_attention(generator, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                               cfg.resolved_head_dim, cfg.qk_norm),
        "moe": init_moe_mlp(generator, cfg),
        "norm1": ones(),
        "norm2": ones(),
    }


def init_moe_params(generator: torch.Generator, cfg: ModelConfig, device="cuda") -> dict:
    """Random params in the reference's tree layout, built layer by layer on
    ``device`` (the generator's) as ``transformer.init_dense_params`` builds
    them: one layer drawn in f32 (2.5 GB at 30b-a3b's width, 10 GB at
    235b-a22b's), cast and stacked, so no f32 copy of the tree exists."""
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


_LAYER_KEYS = {"attn", "moe", "norm1", "norm2"}


def params_from_jax(tree: dict, cfg: ModelConfig, device="cuda", dtype=None) -> dict:
    """The port's params from the reference's MoE tree, already numpy
    (``jax.tree.map(np.asarray, params)``): the same layout, transferred."""
    if set(tree.get("layers", {})) != _LAYER_KEYS:
        raise ValueError(f"layer tree has {sorted(tree.get('layers', {}))}, "
                         f"expected {sorted(_LAYER_KEYS)}")
    return transfer_params(tree, {"embed", "layers", "final_norm", "lm_head", "flow"},
                           device, dtype)


def _block(p: dict, cfg: ModelConfig, h: Tensor, positions: Tensor, causal: bool,
           window: int) -> tuple[Tensor, Tensor]:
    h = h + attention_forward(p["attn"], rms_norm(h, p["norm1"], cfg.norm_eps), positions,
                              n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                              head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
                              causal=causal, window=window, norm_eps=cfg.norm_eps)
    mlp_out, aux = moe_mlp(p["moe"], rms_norm(h, p["norm2"], cfg.norm_eps), cfg)
    return h + mlp_out, aux


def moe_hidden(params: dict, cfg: ModelConfig, h: Tensor, positions: Tensor, *,
               causal: bool = True, window: int = 0,
               remat: bool = False) -> tuple[Tensor, Tensor]:
    """The layer stack and the final norm -> (h, mean aux loss over layers).
    ``remat`` recomputes each layer in the backward, as ``dense_hidden``."""
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for p in layer_views(params["layers"])[:cfg.n_layers]:
        if remat:
            h, a = checkpoint(_block, p, cfg, h, positions, causal, window,
                              use_reentrant=False)
        else:
            h, a = _block(p, cfg, h, positions, causal, window)
        aux = aux + a
    return rms_norm(h, params["final_norm"], cfg.norm_eps), aux / cfg.n_layers


def decode_step(params: dict, cfg: ModelConfig, token: Tensor, caches, *,
                window: int = 0, paged_kernel: bool = False,
                active: Optional[Tensor] = None):
    """One-token decode over a dense ``KVCache`` or a ``PagedKVCache``,
    updated in place: ``transformer.decode_step`` with the MoE feed-forward.
    Every row is routed (the reference computes all rows too); ``active``
    only picks the rows whose state advances."""
    return transformer.decode_step(
        params, cfg, token, caches, window=window, paged_kernel=paged_kernel,
        active=active, mlp=lambda p, x: moe_mlp(p["moe"], x, cfg)[0])
