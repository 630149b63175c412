"""Grouped-query attention with RoPE: the full-sequence path.

Port of the full-sequence part of ``repro.models.attention``. Layouts keep KV
heads grouped — q is reshaped to (B, L, KV, G, hd) with G = H / KV — so GQA
never materializes repeated K/V.

On a CUDA tensor, causal or bidirectional attention without a window runs the
flash kernel (``kernels.flash_attention``) at any length. On the CPU,
``_grouped_attend`` is the path, in the reference's rounding order. Decode and
paged attention (ROADMAP Queue A item 9), cross-attention (item 10) and
sliding windows come with their slices.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.ops import attend
from repro_torch.models.layers import apply_rope, dense_init, rms_norm

Tensor = torch.Tensor
NEG_INF = -1e30


def init_attention(generator: torch.Generator, d_model: int, n_heads: int,
                   n_kv: int, head_dim: int, qk_norm: bool = False) -> dict:
    """f32 weights on the generator's device."""
    p = {
        "wq": dense_init(generator, d_model, n_heads * head_dim),
        "wk": dense_init(generator, d_model, n_kv * head_dim),
        "wv": dense_init(generator, d_model, n_kv * head_dim),
        "wo": dense_init(generator, n_heads * head_dim, d_model),
    }
    if qk_norm:
        p["q_norm"] = torch.ones((head_dim,), dtype=torch.float32, device=generator.device)
        p["k_norm"] = torch.ones((head_dim,), dtype=torch.float32, device=generator.device)
    return p


def _grouped_attend(q: Tensor, k: Tensor, v: Tensor, mask: Optional[Tensor]) -> Tensor:
    """q: (B, Lq, KV, G, hd); k, v: (B, Lk, KV, hd); mask: (B or 1, Lq, Lk) bool.

    Scores in the input dtype, then f32; softmax weights cast back to v's
    dtype — the reference's rounding order.
    """
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqkgh,bskh->bkgqs", q * scale, k).to(torch.float32)
    if mask is not None:
        scores = torch.where(mask[:, None, None, :, :], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bkgqs,bskh->bqkgh", w, v)


def _split_heads(x: Tensor, n: int, hd: int) -> Tensor:
    return x.reshape(x.shape[:-1] + (n, hd))


def attention_forward(
    p: dict,
    x: Tensor,                   # (B, L, d)
    positions: Tensor,           # (L,) increasing absolute positions
    *,
    n_heads: int,
    n_kv: int,
    head_dim: int,
    rope_theta: float,
    causal: bool = True,
    window: int = 0,
    norm_eps: float = 1e-5,
) -> Tensor:
    """Full-sequence attention (training / prefill / flow forward).

    The kernel masks by index (key j <= query i), which equals the
    reference's position mask for increasing positions.
    """
    B, L, _ = x.shape
    G = n_heads // n_kv
    q = _split_heads(x @ p["wq"], n_heads, head_dim)
    k = _split_heads(x @ p["wk"], n_kv, head_dim)
    v = _split_heads(x @ p["wv"], n_kv, head_dim)
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"], norm_eps)
        k = rms_norm(k, p["k_norm"], norm_eps)
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)

    if x.is_cuda:
        if window:
            raise NotImplementedError(
                "sliding-window attention has no CUDA kernel yet "
                "(ROADMAP Queue A item 9)")
        out = attend(q, k, v, causal=causal)                  # (B, L, H, hd)
    else:
        mask = None
        if causal:
            rel = positions[:, None] - positions[None, :]      # (L, L)
            mask = rel >= 0
            if window:
                mask = mask & (rel < window)
            mask = mask[None]
        out = _grouped_attend(q.reshape(B, L, n_kv, G, head_dim), k, v, mask)
    return out.reshape(B, L, n_heads * head_dim) @ p["wo"]
