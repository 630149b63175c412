"""Shared neural building blocks (plain functions on tensors).

Port of ``repro.models.layers``. Parameter trees are plain nested dicts of
tensors in the reference's layout: matrices are (d_in, d_out), applied as
``x @ W``, and layer stacks carry a leading layer axis. Initializers take an
explicit ``torch.Generator`` where the reference takes a PRNG key.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


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
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


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
    log_period = torch.log(torch.tensor(max_period, dtype=torch.float32, device=t.device))
    freqs = torch.exp(-log_period * torch.arange(half, dtype=torch.float32,
                                                 device=t.device) / half)
    ang = t[..., None] * freqs * 1000.0
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)
