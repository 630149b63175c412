"""Grouped-query attention with RoPE: the full-sequence and decode paths.

Port of ``repro.models.attention``. Layouts keep KV heads grouped — q is
reshaped to (B, L, KV, G, hd) with G = H / KV — so GQA never materializes
repeated K/V.

On a CUDA tensor, causal or bidirectional attention without a window runs the
flash kernel (``kernels.flash_attention``) at any length. A sliding window
(``window > 0``) runs on the card as on the CPU, through the masked plain
path, as the reference routes it (its flash kernel takes no window either):
``_grouped_attend``, in the reference's rounding order, or, under an
installed context's ``q_chunk`` (``distributed.context``), its query-chunked
form ``_chunked_attend``. On the CPU every call takes those plain paths.

Decode attends one new token over a KV cache: a dense per-row cache
(``KVCache``, a ring buffer when ``window > 0``) in plain torch, as the
reference has no kernel for it, or a shared page pool (``PagedKVCache``)
through the paged-attention kernel (``kernel=True``) or the reference's
dense-gather path (``kernel=False``). Where JAX rebuilt the cache every
step, the port writes it IN PLACE: the dense cache only in the rows a step
advances (the others keep their bits), the page pool unconditionally, as
the reference's pool is (page ownership isolates rows; inactive rows write
into the trash page 0). Cross-attention (whisper's decoder) attends over an
encoder memory without mask or RoPE, through the flash kernel on the card.

On a mesh (DTensors, ``serving.sharded``) attention runs on each rank's
local shards (``_local_heads``: the batch over the data axes, the heads over
``model`` where both head counts divide it), and a dense decode cache
decodes on its local shards (``_decode_on_shards``), the softmax partials
of the ranks that split its slots (where the KV heads do not divide
``model``) merged by log-sum-exp.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.distributed import context
from repro_torch.kernels import dtensor
from repro_torch.kernels.flash_attention.ops import attend, paged_attend
from repro_torch.models.layers import apply_rope, dense_init, rms_norm, split_heads

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


def _position_mask(pos_q: Tensor, positions: Tensor, window: int) -> Tensor:
    """(1, Lq, Lk) bool: key position <= query position, and within
    ``window`` of it when ``window > 0``."""
    rel = pos_q[:, None] - positions[None, :]
    mask = rel >= 0
    if window:
        mask = mask & (rel < window)
    return mask[None]


def _chunked_attend(q: Tensor, k: Tensor, v: Tensor, positions: Tensor,
                    causal: bool, window: int, qc: int) -> Tensor:
    """``_grouped_attend`` over query chunks of ``qc`` (L divisible by it):
    the scores held at once are (B, KV, G, qc, Lk), never (L, L), and each
    chunk's mask comes from index compares. q: (B, L, KV, G, hd)."""
    L = q.shape[1]
    outs = []
    for i in range(0, L, qc):
        mask = _position_mask(positions[i:i + qc], positions, window) if causal else None
        outs.append(_grouped_attend(q[:, i:i + qc], k, v, mask))
    return torch.cat(outs, dim=1)


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
    reference's position mask for increasing positions. A window, or any
    call on the CPU, takes the masked plain path (query-chunked under an
    installed ``q_chunk`` that divides L), whose backward is autograd's.
    """
    B, L, _ = x.shape
    G = n_heads // n_kv
    q = split_heads(x @ p["wq"], n_heads, head_dim)
    k = split_heads(x @ p["wk"], n_kv, head_dim)
    v = split_heads(x @ p["wv"], n_kv, head_dim)
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"], norm_eps)
        k = rms_norm(k, p["k_norm"], norm_eps)
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)

    if x.is_cuda and not window:
        out = _local_heads(lambda q, k, v: attend(q, k, v, causal=causal), q, k, v)
    else:
        out = _local_heads(lambda q, k, v: _plain_attend(q, k, v, positions, causal, window),
                           q, k, v)
    return context.pin_batch(out @ p["wo"])


def _plain_attend(q: Tensor, k: Tensor, v: Tensor, positions: Tensor, causal: bool,
                  window: int) -> Tensor:
    """The masked plain path in the model layout: q (B, L, H, hd), k, v
    (B, Lk, KV, hd) -> (B, L, H, hd); query-chunked under an installed
    ``q_chunk`` that divides L."""
    B, L, H, hd = q.shape
    q = q.reshape(B, L, k.shape[2], H // k.shape[2], hd)
    qc = context.q_chunk()
    if qc and L > qc and L % qc == 0:
        out = _chunked_attend(q, k, v, positions, causal, window, qc)
    else:
        mask = _position_mask(positions, positions, window) if causal else None
        out = _grouped_attend(q, k, v, mask)
    return out.reshape(B, L, H, hd)


def _local_heads(fn, q: Tensor, k: Tensor, v: Tensor) -> Tensor:
    """``fn(q, k, v)`` in the model layout ((B, L, heads, hd) each) with its
    heads merged, (B, L, H * hd); on each rank's local shards when they are
    DTensors: the batch over the data axes, the heads over ``model`` where
    both head counts divide it (``kernels.dtensor.local_call``). DTensor's
    own propagation would contract the scores over a split head dim and
    all-reduce them, (L, L) a head; and the merge is made on the local
    shards, so no gradient is ever viewed as heads that a split cuts
    (40 heads over a ``model`` axis of 16)."""
    def merged(q, k, v):
        return fn(q, k, v).flatten(2)

    if type(q) is torch.Tensor or not dtensor.any_dtensor(q, k, v):
        return merged(q, k, v)
    return dtensor.local_call(merged, (q, k, v), batch_dims=(0, 0, 0), head_dims=(2, 2, 2),
                              out_batch_dim=0, out_head_dim=2)


def cross_attention_forward(
    p: dict,
    x: Tensor,                   # (B, L, d) decoder states
    memory: Tensor,              # (B, M, d_mem) encoder states
    *,
    n_heads: int,
    head_dim: int,
) -> Tensor:
    """Encoder-decoder cross attention (no mask, no RoPE; K and V projected
    from ``memory``; the whisper decoder), for any L and M: on a CUDA tensor
    the flash kernel, non-causal, on the CPU ``_grouped_attend``. ``memory``
    is cast to x's dtype first, where JAX would promote x to memory's (an f32
    memory under a bf16 decoder; the reference's scan then raises): at f32 a
    no-op."""
    B, L, _ = x.shape
    memory = memory.to(x.dtype)
    q = split_heads(x @ p["wq"], n_heads, head_dim)
    k = split_heads(memory @ p["wk"], n_heads, head_dim)
    v = split_heads(memory @ p["wv"], n_heads, head_dim)
    if x.is_cuda:
        out = _local_heads(lambda q, k, v: attend(q, k, v, causal=False), q, k, v)
    else:
        out = _local_heads(lambda q, k, v: _grouped_attend(
            q.reshape(q.shape[:3] + (1, head_dim)), k, v, None), q, k, v)
    return context.pin_batch(out @ p["wo"])


def _project_new_token(p: dict, x: Tensor, pos: Tensor, *, n_heads: int, n_kv: int,
                       head_dim: int, rope_theta: float, norm_eps: float):
    """q, k, v of the new token (B, 1, heads, hd), RoPE'd at each row's ``pos``."""
    q = split_heads(x @ p["wq"], n_heads, head_dim)
    k_new = split_heads(x @ p["wk"], n_kv, head_dim)
    v_new = split_heads(x @ p["wv"], n_kv, head_dim)
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
    if type(cache.k) is not torch.Tensor and dtensor.any_dtensor(cache.k):
        out = _decode_on_shards(q[:, 0], k_new, v_new, pos, slot, active, cache.k, cache.v,
                                window)
        out = context.pin_batch(out.reshape(B, 1, n_heads * head_dim) @ p["wo"])
        return out, cache._replace(index=pos + 1)
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
    out = context.pin_batch(out.reshape(B, 1, n_heads * head_dim) @ p["wo"])
    return out, cache._replace(index=pos + 1)


def _decode_on_shards(q: Tensor, k_new: Tensor, v_new: Tensor, pos: Tensor, slot: Tensor,
                      active: Optional[Tensor], kbuf, vbuf, window: int) -> Tensor:
    """One-token decode over a DTensor cache (B, slots, KV, hd), laid out as
    the mesh splits it (``distributed.sharding.cache_spec``): along its
    batch, its KV heads where they divide ``model``, and else along its
    slots (on ``model``, or, at a batch of one, on the data axes); on a
    1 x 1 mesh, along nothing. k_new, v_new: (B, KV, hd) in the cache's
    dtype.

    Each rank runs on its local shard of the cache and the matching shards
    of q and the new K/V: it writes the rows whose slot falls in its shard,
    at the local offset (IN PLACE, into the cache's local tensor), scores its own slots,
    and keeps their max, the sum of their exponentials and the weighted sum
    of their values; the partials are merged across the mesh axes that
    split the slots by log-sum-exp (all-reduce of the max, then of the
    rescaled sums), as ``paged_attention`` merges its splits. q: (B, H, hd);
    returns (B, H, hd) in q's dtype, laid out as q is."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh, cpl = kbuf.device_mesh, tuple(kbuf.placements)

    def like(dims: dict) -> list:
        return [Shard(dims[pl.dim]) if isinstance(pl, Shard) and pl.dim in dims
                else Replicate() for pl in cpl]

    row_pl, head_pl = like({0: 0}), like({0: 0, 2: 1})
    split = [i for i, pl in enumerate(cpl) if isinstance(pl, Shard) and pl.dim == 1]
    first, _ = dtensor.shard_extent(mesh, cpl, 1, kbuf.shape[1])
    slots = kbuf.shape[1]

    def core(q, k_new, v_new, pos, slot, active, k, v):
        n = k.shape[1]
        rows = torch.arange(k.shape[0], device=k.device)
        local = (slot - first).clamp(0, n - 1)
        write = (slot >= first) & (slot < first + n)
        if active is not None:
            write = write & active
        keep = write[:, None, None]
        k[rows, local] = torch.where(keep, k_new, k[rows, local])
        v[rows, local] = torch.where(keep, v_new, v[rows, local])
        ids = first + torch.arange(n, device=k.device)
        if window:
            valid = ids[None, :] < torch.clamp(pos + 1, max=slots)[:, None]
        else:
            valid = ids[None, :] <= pos[:, None]
        kq, vq = k.to(q.dtype), v.to(q.dtype)
        qg = q.reshape(q.shape[0], k.shape[2], -1, q.shape[-1])      # (B, KV, G, hd)
        scores = torch.einsum("bkgh,bskh->bkgs", qg * q.shape[-1] ** -0.5, kq)
        scores = torch.where(valid[:, None, None, :], scores.to(torch.float32), NEG_INF)
        m = scores.amax(-1)
        e = torch.where(valid[:, None, None, :], torch.exp(scores - m[..., None]), 0.0)
        lsum = e.sum(-1)
        o = torch.einsum("bkgs,bskh->bkgh", e.to(vq.dtype), vq).to(torch.float32)
        for dim in split:
            top = funcol.all_reduce(m, "max", (mesh, dim))
            scale = torch.exp(m - top)
            lsum = funcol.all_reduce(lsum * scale, "sum", (mesh, dim))
            o = funcol.all_reduce(o * scale[..., None], "sum", (mesh, dim))
            m = top
        return (o / lsum[..., None]).to(q.dtype).reshape(q.shape)

    def placed(x, pl):
        if x is None or isinstance(x, DTensor):
            return x
        return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)

    args = (q, k_new, v_new, pos, slot, active, kbuf, vbuf)
    in_pl = (head_pl, head_pl, head_pl, row_pl, row_pl,
             None if active is None else row_pl, list(cpl), list(cpl))
    return local_map(core, head_pl, in_placements=in_pl, device_mesh=mesh,
                     redistribute_inputs=True)(*(placed(x, pl) for x, pl in zip(args, in_pl)))


def _local(x, buf, dims: dict) -> Tensor:
    """The local shard of ``x`` laid out as the DTensor ``buf`` is along the
    dims ``dims`` maps (buf's dim -> x's), replicated along the rest; a
    plain ``x`` counts as replicated."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = buf.device_mesh
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)
    want = [Shard(dims[p.dim]) if isinstance(p, Shard) and p.dim in dims else Replicate()
            for p in buf.placements]
    return x.redistribute(mesh, want).to_local()


def _split_along(buf, dims) -> bool:
    from torch.distributed.tensor import Shard

    return any(isinstance(p, Shard) and p.dim in dims for p in buf.placements)


def _write_pages(pool: Tensor, page: Tensor, off: Tensor, new: Tensor) -> None:
    """``pool[page[b], off[b]] = new[b]`` in place: pool (pages, page_size, KV,
    hd), new (B, KV, hd). A DTensor pool takes the write on each rank's local
    shard: every row's page and offset, and every row's new K or V along the
    pool's heads split (a pool is shared by all rows, so each rank writes all
    of them)."""
    if type(pool) is torch.Tensor:
        pool[page, off] = new
        return
    if _split_along(pool, (0, 1)):
        raise NotImplementedError("a decode write into a pool split along its pages")
    pool.to_local()[_local(page, pool, {}), _local(off, pool, {})] = \
        _local(new, pool, {2: 1, 3: 2})


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
    _write_pages(k_pages, page, off, k_new[:, 0].to(k_pages.dtype))
    _write_pages(v_pages, page, off, v_new[:, 0].to(v_pages.dtype))

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
