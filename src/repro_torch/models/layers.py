"""Shared neural building blocks (plain functions on tensors).

Port of ``repro.models.layers``. Parameter trees are plain nested dicts of
tensors in the reference's layout: matrices are (d_in, d_out), applied as
``x @ W``, and layer stacks carry a leading layer axis. Initializers take an
explicit ``torch.Generator`` where the reference takes a PRNG key.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed import context

Tensor = torch.Tensor


def split_heads(x: Tensor, n: int, hd: int) -> Tensor:
    """(..., n * hd) -> (..., n, hd). A DTensor split along its last dim
    into parts that are not whole heads (4 KV heads over a ``model`` axis
    of 16) is gathered along those axes first: DTensor cannot view such a
    split as heads."""
    if type(x) is not torch.Tensor:
        from torch.distributed.tensor import DTensor, Replicate, Shard

        if isinstance(x, DTensor):
            # a column-parallel product's output, whose rows DTensor may have
            # split on ``model`` too: rows with the batch, features on ``model``
            x = context.pin_batch(x, model_last=True)
            last, mesh = x.dim() - 1, x.device_mesh
            pl = [Replicate() if isinstance(p, Shard) and p.dim == last and n % mesh.size(i)
                  else p for i, p in enumerate(x.placements)]
            if pl != list(x.placements):
                x = x.redistribute(mesh, pl)
    return x.reshape(x.shape[:-1] + (n, hd))


def embed(table: Tensor, tokens: Tensor) -> Tensor:
    """``table[tokens]``: the rows of an embedding table, laid out as the
    batch under an installed sharding context (``context.pin_batch``). A
    DTensor table is read on each rank's local shard (``_embed_on_shards``)."""
    if type(table) is not torch.Tensor and hasattr(table, "device_mesh"):
        return context.pin_batch(_embed_on_shards(table, tokens))
    return context.pin_batch(table[tokens.long()])


def _embed_on_shards(table, tokens):
    """Megatron's vocab-parallel embedding through ``local_map``: the table
    gathered along every mesh axis but the one that splits its vocab (the
    FSDP split of its width), each rank's rows read from its vocab slice and
    zeros elsewhere, the ranks' rows summed over that axis. The tokens keep
    their batch split. DTensor's own gather (and its backward's
    ``index_put``) has no rule for a width split over two axes on the
    card's torch."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.kernels import dtensor

    mesh = table.device_mesh
    if not isinstance(tokens, DTensor):
        tokens = DTensor.from_local(tokens, mesh, [Replicate()] * mesh.ndim, run_check=False)
    vocab = [p if isinstance(p, Shard) and p.dim == 0 else Replicate() for p in table.placements]
    rows = [p if isinstance(p, Shard) and p.dim == 0 else Replicate() for p in tokens.placements]
    out = [Partial() if isinstance(v, Shard) else r for v, r in zip(vocab, rows)]
    # each rank's table gradient is its own tokens' share where they split
    grad = [Partial() if isinstance(r, Shard) else v for v, r in zip(vocab, rows)]
    first, _ = dtensor.shard_extent(mesh, vocab, 0, table.shape[0])

    def local(table, tokens):
        idx = tokens.long() - first
        inside = (idx >= 0) & (idx < table.shape[0])
        got = table[idx.clamp(0, table.shape[0] - 1)]
        return torch.where(inside[..., None], got, torch.zeros((), dtype=got.dtype,
                                                               device=got.device))

    return local_map(local, out, in_placements=(vocab, rows), in_grad_placements=(grad, rows),
                     device_mesh=mesh, redistribute_inputs=True)(table, tokens)


def dense_init(generator: torch.Generator, d_in: int, d_out: int,
               scale: float | None = None) -> Tensor:
    """A (d_in, d_out) f32 normal draw times ``scale`` (default d_in**-0.5),
    on the generator's device."""
    scale = scale if scale is not None else d_in ** -0.5
    w = torch.randn((d_in, d_out), generator=generator, dtype=torch.float32,
                    device=generator.device)
    return w.mul_(scale)


def rms_norm(x: Tensor, weight: Tensor, eps: float = 1e-5) -> Tensor:
    dtype = x.dtype
    x = x.to(torch.float32)
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * weight).to(dtype)


def swiglu(x: Tensor, w_gate: Tensor, w_up: Tensor, w_down: Tensor) -> Tensor:
    hidden = context.pin_batch(F.silu(x @ w_gate) * (x @ w_up), model_last=True)
    return context.pin_batch(hidden @ w_down)


def rope_frequencies(head_dim: int, theta: float, device=None) -> Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq). Half-split
    rotation in f32, result in x's dtype."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, device=x.device)              # (hd/2,)
    angles = positions[..., None].to(torch.float32) * freqs           # (..., seq, hd/2)
    cos = torch.cos(angles)[..., None, :]                             # (..., seq, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def timestep_embedding(t, dim: int, max_period: float = 10_000.0, *,
                       device=None) -> Tensor:
    """Sinusoidal flow-time embedding; t scalar or (batch,). Returns (1 or batch, dim)."""
    t = torch.atleast_1d(torch.as_tensor(t, dtype=torch.float32, device=device))
    half = dim // 2
    # a fill on the device, not a host-to-device copy (which a CUDA graph cannot capture)
    log_period = torch.log(torch.full((), max_period, dtype=torch.float32, device=t.device))
    freqs = torch.exp(-log_period * torch.arange(half, dtype=torch.float32,
                                                 device=t.device) / half)
    ang = t[..., None] * freqs * 1000.0
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)
