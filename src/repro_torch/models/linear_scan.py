"""Chunked gated-linear-recurrence primitive (RWKV6's wkv; Mamba2's SSD form).

Port of ``repro.models.linear_scan``. Recurrence, per batch row and head:

    S_t = diag(exp(ld_t)) S_{t-1} + k_t v_t^T          S in (dk, dv)
    o_t = q_t^T S_t                  ("inclusive", Mamba2/SSD convention)
    o_t = q_t^T S_{t-1}              ("exclusive", RWKV wkv convention)

``gla_chunked`` takes blocks of ``chunk`` tokens with matrix products and
carries the (dk, dv) state across blocks; every decay factor it evaluates is
``exp`` of a difference of within-chunk cumulative log-decays clamped at 0,
so no exponent is positive however strong the decay. It is the plain version
of the ``gla_scan`` CUDA kernel (``kernels/gla_scan``), which CPU tensors take.
``gla_recurrent`` is the step-by-step oracle; ``gla_step`` is one decode step.
Everything is computed in f32 (in f64 for f64 inputs, so the oracle can be
taken exactly); outputs take v's dtype, the state is f32 (f64).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def _acc(x: Tensor) -> torch.dtype:
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _initial_state(q: Tensor, dv: int, s0: Optional[Tensor]) -> Tensor:
    B, _, H, dk = q.shape
    if s0 is None:
        return torch.zeros((B, H, dk, dv), dtype=_acc(q), device=q.device)
    return s0.to(_acc(q))


def gla_step(q: Tensor, k: Tensor, v: Tensor, ld: Tensor, S: Tensor, *,
             inclusive: bool = True) -> tuple[Tensor, Tensor]:
    """One step. q, k, ld: (B, H, dk); v: (B, H, dv); S: (B, H, dk, dv) f32.
    Returns (o (B, H, dv) in v's dtype, new S). DTensors run on each rank's
    local shards: the batch over the data axes, the heads over ``model``
    where they divide it (``kernels.dtensor.local_call``)."""
    if type(v) is not torch.Tensor:
        from repro_torch.kernels import dtensor

        if dtensor.any_dtensor(q, k, v, ld, S):
            return dtensor.local_call(
                lambda q, k, v, ld, S: gla_step(q, k, v, ld, S, inclusive=inclusive),
                (q, k, v, ld, S), batch_dims=(0,) * 5, head_dims=(1,) * 5,
                out_batch_dim=(0, 0), out_head_dim=(1, 1))
    acc = _acc(q)
    decay = torch.exp(ld.to(acc))[..., None]
    kv = k[..., None].to(acc) * v[..., None, :].to(acc)
    S_new = decay * S + kv
    S_read = S_new if inclusive else S
    o = torch.einsum("bhd,bhdv->bhv", q.to(acc), S_read)
    return o.to(v.dtype), S_new


def gla_recurrent(q: Tensor, k: Tensor, v: Tensor, ld: Tensor,
                  s0: Optional[Tensor] = None, *, inclusive: bool = True
                  ) -> tuple[Tensor, Tensor]:
    """Oracle: one ``gla_step`` per position. q, k, ld: (B, L, H, dk) (ld's
    last dim may be 1); v: (B, L, H, dv). Returns (o (B, L, H, dv) in v's
    dtype, final state (B, H, dk, dv) f32)."""
    S = _initial_state(q, v.shape[-1], s0)
    outs = []
    for t in range(q.shape[1]):
        o, S = gla_step(q[:, t], k[:, t], v[:, t], ld[:, t], S, inclusive=inclusive)
        outs.append(o)
    return torch.stack(outs, dim=1), S


def gla_chunked(q: Tensor, k: Tensor, v: Tensor, ld: Tensor,
                s0: Optional[Tensor] = None, *, inclusive: bool = True,
                chunk: int = 64) -> tuple[Tensor, Tensor]:
    """Chunked-parallel form; shapes as ``gla_recurrent``, any L (padded
    internally to a chunk multiple with k = v = 0 and ld = 0, so pad steps
    leave the state and the real outputs alone). A trailing ld dim of 1 is
    one decay per head (the Mamba2 form): its intra-chunk decay matrix is
    (c, c) instead of (c, c, dk)."""
    B, L, H, dk = q.shape
    dv = v.shape[-1]
    chunk = min(chunk, L)
    pad = (-L) % chunk
    if pad:
        q, k, v, ld = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (q, k, v, ld))
    n_chunks = (L + pad) // chunk

    def to_chunks(a):                                   # (N, B, H, c, dx)
        return a.reshape(B, n_chunks, chunk, H, a.shape[-1]).permute(1, 0, 3, 2, 4)

    qc, kc, vc, ldc = map(to_chunks, (q, k, v, ld))
    S = _initial_state(q, dv, s0)
    idx = torch.arange(chunk, device=q.device)
    tri = idx[:, None] >= idx[None, :] if inclusive else idx[:, None] > idx[None, :]
    scalar_decay = ld.shape[-1] == 1
    acc = _acc(q)

    outs = []
    for i in range(n_chunks):
        q_, k_, v_, ld_ = (a[i].to(acc) for a in (qc, kc, vc, ldc))
        cum = torch.cumsum(ld_, dim=2)                  # (B, H, c, dk|1)
        cum_q = cum if inclusive else cum - ld_         # decay endpoint: t or t-1
        o_cross = torch.einsum("bhtd,bhdv->bhtv", q_ * torch.exp(cum_q), S)
        if scalar_decay:
            dd = cum_q[:, :, :, None, 0] - cum[:, :, None, :, 0]         # (B, H, t, s)
            scores = (q_ @ k_.transpose(-1, -2)) * torch.exp(dd.clamp(max=0.0))
        else:
            dd = cum_q[:, :, :, None, :] - cum[:, :, None, :, :]         # (B, H, t, s, dk)
            scores = (q_[:, :, :, None, :] * k_[:, :, None, :, :]
                      * torch.exp(dd.clamp(max=0.0))).sum(-1)
        scores = torch.where(tri, scores, 0.0)
        outs.append(o_cross + scores @ v_)
        # S' = diag(e^{cum_end}) S + sum_s (k_s e^{cum_end - cum_s}) v_s
        cum_end = cum[:, :, -1:, :]
        k_scaled = k_ * torch.exp(cum_end - cum)
        S = (torch.exp(cum_end[:, :, 0, :].expand(S.shape[:-1]))[..., None] * S
             + torch.einsum("bhsd,bhsv->bhdv", k_scaled, v_))
    o = torch.stack(outs).permute(1, 0, 3, 2, 4).reshape(B, L + pad, H, dv)[:, :L]
    return o.to(v.dtype), S
