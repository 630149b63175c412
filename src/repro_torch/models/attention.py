"""Grouped-query attention with RoPE: the full-sequence and decode paths.

Port of ``repro.models.attention``. Layouts keep KV heads grouped — q is
reshaped to (B, L, KV, G, hd) with G = H / KV — so GQA never materializes
repeated K/V.

On a CUDA tensor, causal or bidirectional attention without a window runs the
flash kernel (``kernels.flash_attention``) at any length. On the CPU,
``_grouped_attend`` is the path, in the reference's rounding order.

Decode attends one new token over a KV cache: a dense per-row cache
(``KVCache``, a ring buffer when ``window > 0``) in plain torch, as the
reference has no kernel for it, or a shared page pool (``PagedKVCache``)
through the paged-attention kernel (``kernel=True``) or the reference's
dense-gather path (``kernel=False``). Where JAX rebuilt the cache every
step, the port writes it IN PLACE: the dense cache only in the rows a step
advances (the others keep their bits), the page pool unconditionally, as
the reference's pool is (page ownership isolates rows; inactive rows write
into the trash page 0). Cross-attention (ROADMAP Queue A item 10) and
sliding-window prefill on the card come with their slices.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels.flash_attention.ops import attend, paged_attend
from repro_torch.models.layers import apply_rope, dense_init, rms_norm

Tensor = torch.Tensor
NEG_INF = -1e30


class KVCache(NamedTuple):
    k: Tensor       # (B, slots, KV, hd), or (L, B, slots, KV, hd) stacked per layer
    v: Tensor
    index: Tensor   # int32 tokens already decoded: scalar, or (B,) per row
    #                 (slot serving: each batch row at its own position)

    @property
    def slots(self) -> int:
        return self.k.shape[-3]


class PagedKVCache(NamedTuple):
    """vLLM-style paged KV cache: K/V live in a SHARED pool of fixed-size
    pages and each sequence row owns a block-table row mapping its logical
    block index to a physical page id.

    Page 0 is RESERVED as the trash page: freed or inactive rows' block-table
    entries point at it, so the write a masked-out row still makes lands in
    a page nobody attends over. The page allocator
    (``repro_torch.serving.decode.PageAllocator``) never hands page 0 out.
    """

    k_pages: Tensor      # (L, num_pages, page_size, KV, hd) shared pool
    v_pages: Tensor
    block_table: Tensor  # (B, blocks_per_slot) int32 physical page ids
    index: Tensor        # (B,) int32 tokens already decoded per row

    @property
    def page_size(self) -> int:
        return self.k_pages.shape[-3]

    @property
    def capacity(self) -> int:
        """Logical positions addressable per row (block-table width x page
        size): the paged analogue of ``KVCache.slots``."""
        return self.block_table.shape[1] * self.page_size


def init_kv_cache(batch: int, slots: int, n_kv: int, head_dim: int,
                  dtype=torch.bfloat16, device="cuda") -> KVCache:
    shape = (batch, slots, n_kv, head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   index=torch.zeros((), dtype=torch.int32, device=device))


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
                "(ROADMAP Queue A item 10)")
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


def _project_new_token(p: dict, x: Tensor, pos: Tensor, *, n_heads: int, n_kv: int,
                       head_dim: int, rope_theta: float, norm_eps: float):
    """q, k, v of the new token (B, 1, heads, hd), RoPE'd at each row's ``pos``."""
    q = _split_heads(x @ p["wq"], n_heads, head_dim)
    k_new = _split_heads(x @ p["wk"], n_kv, head_dim)
    v_new = _split_heads(x @ p["wv"], n_kv, head_dim)
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"], norm_eps)
        k_new = rms_norm(k_new, p["k_norm"], norm_eps)
    posb = pos[:, None]                                         # (B, 1)
    return apply_rope(q, posb, rope_theta), apply_rope(k_new, posb, rope_theta), v_new


def decode_attention(
    p: dict,
    x: Tensor,                   # (B, 1, d) — the new token
    cache: KVCache,
    *,
    n_heads: int,
    n_kv: int,
    head_dim: int,
    rope_theta: float,
    window: int = 0,
    norm_eps: float = 1e-5,
    active: Optional[Tensor] = None,
) -> tuple[Tensor, KVCache]:
    """One-token decode over a dense KV cache (ring buffer when window > 0).

    ``cache.index`` is a scalar (the whole batch at one position) or a per-row
    (B,) vector (slot serving); RoPE, the write slot and the validity mask are
    per row. The new K/V are written into ``cache`` IN PLACE, and only in the
    rows ``active`` (B,) bool picks (all rows when None): the other rows keep
    every bit. Returns (out, cache with index + 1); the caller masks the index
    of inactive rows.
    """
    B, Lq, _ = x.shape
    if Lq != 1:
        raise ValueError(f"decode_attention takes one new token, got {Lq}")
    G = n_heads // n_kv
    pos = cache.index.to(torch.int32).expand(B)                # per-row position
    q, k_new, v_new = _project_new_token(p, x, pos, n_heads=n_heads, n_kv=n_kv,
                                         head_dim=head_dim, rope_theta=rope_theta,
                                         norm_eps=norm_eps)
    slots = cache.slots
    slot = (pos % slots if window else pos.clamp(max=slots - 1)).long()
    rows = torch.arange(B, device=x.device)
    k_new = k_new[:, 0].to(cache.k.dtype)
    v_new = v_new[:, 0].to(cache.v.dtype)
    if active is not None:     # inactive rows write back what they hold
        keep = active[:, None, None]
        k_new = torch.where(keep, k_new, cache.k[rows, slot])
        v_new = torch.where(keep, v_new, cache.v[rows, slot])
    cache.k[rows, slot] = k_new
    cache.v[rows, slot] = v_new

    slot_ids = torch.arange(slots, device=x.device)
    if window:
        valid = slot_ids[None, :] < torch.clamp(pos + 1, max=slots)[:, None]
    else:
        valid = slot_ids[None, :] <= pos[:, None]
    q = q.reshape(B, 1, n_kv, G, head_dim)
    out = _grouped_attend(q, cache.k.to(q.dtype), cache.v.to(q.dtype), valid[:, None, :])
    out = out.reshape(B, 1, n_heads * head_dim) @ p["wo"]
    return out, cache._replace(index=pos + 1)


def decode_attention_paged(
    p: dict,
    x: Tensor,                   # (B, 1, d) — the new token
    k_pages: Tensor,             # (num_pages, page_size, KV, hd) one layer
    v_pages: Tensor,
    block_table: Tensor,         # (B, nb) int32 page ids
    pos: Tensor,                 # (B,) int32 decode position per row
    *,
    n_heads: int,
    n_kv: int,
    head_dim: int,
    rope_theta: float,
    norm_eps: float = 1e-5,
    kernel: bool = False,
) -> Tensor:
    """One-token decode over one layer's slice of a paged KV cache.

    The new K/V land IN PLACE at page ``block_table[b, pos // page_size]``,
    offset ``pos % page_size`` (clamped to the last position, as the dense
    path clamps; the gateway rejects over-capacity requests), whether or not
    the row is active: an inactive row writes into its own next position,
    which it overwrites before reading, or into the trash page 0.
    ``kernel=True`` attends through the paged-attention kernel
    (``ops.paged_attend``); ``kernel=False`` is the reference's dense-gather
    path through ``_grouped_attend``, whose output is bit-identical to
    ``decode_attention`` over a dense cache of ``nb * page_size`` slots.
    Returns the attention output (B, 1, d).
    """
    B, Lq, _ = x.shape
    if Lq != 1:
        raise ValueError(f"decode_attention_paged takes one new token, got {Lq}")
    G = n_heads // n_kv
    ps = k_pages.shape[1]
    nb = block_table.shape[1]
    q, k_new, v_new = _project_new_token(p, x, pos, n_heads=n_heads, n_kv=n_kv,
                                         head_dim=head_dim, rope_theta=rope_theta,
                                         norm_eps=norm_eps)
    posw = pos.clamp(max=nb * ps - 1).long()
    rows = torch.arange(B, device=x.device)
    page = block_table[rows, posw // ps].long()                 # (B,)
    off = posw % ps
    k_pages[page, off] = k_new[:, 0].to(k_pages.dtype)
    v_pages[page, off] = v_new[:, 0].to(v_pages.dtype)

    qg = q.reshape(B, n_kv, G, head_dim)
    if kernel:
        out = paged_attend(qg, k_pages, v_pages, block_table, pos + 1)
        out = out.reshape(B, 1, n_heads * head_dim).to(x.dtype)
    else:
        table = block_table.long()
        k = k_pages[table].reshape(B, nb * ps, n_kv, head_dim)
        v = v_pages[table].reshape(B, nb * ps, n_kv, head_dim)
        valid = torch.arange(nb * ps, device=x.device)[None, :] <= pos[:, None]
        out = _grouped_attend(qg[:, None], k.to(q.dtype), v.to(q.dtype), valid[:, None, :])
        out = out.reshape(B, 1, n_heads * head_dim)
    return out @ p["wo"]
