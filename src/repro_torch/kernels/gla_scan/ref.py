"""Plain PyTorch versions of the gla_scan kernels.

``gla_ref`` is the forward kernel's oracle: the step-by-step recurrence (twin
of the reference's ref.py, which re-exports its ``gla_recurrent``), so the
kernel is held against a form independent of its chunked arithmetic.

``gla_chunked_bwd`` is the closed-form backward that the ``gla_scan_bwd``
kernel computes, chunk by chunk in reverse. With b_t the prefix sum of ld
over the whole sequence (every decay factor of the forward is exp of a
difference of b's), S_t the state after step t and G_t the gradient of the
state after step t:

    dq_t = S_t do_t (inclusive) or S_{t-1} do_t (exclusive)
    dk_t = G_t v_t,   dv_t = G_t^T k_t,   ds0 = diag(e^{ld_0}) G_0
    dL/db_t = q_t * dq_t - k_t * dk_t   (exclusive: q_{t+1} * dq_{t+1})
              + [t = L-1] sum_v dS_final * S_final
    dld_t = sum_{t' >= t} dL/db_t'

The forward's clamp of each exponent at 0 never binds for ld <= 0, which the
models always have (and on the diagonal its two terms cancel), so this is
the gradient of ``gla_chunked`` itself.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.linear_scan import gla_recurrent as gla_ref  # noqa: F401

Tensor = torch.Tensor


def gla_chunked_bwd(q: Tensor, k: Tensor, v: Tensor, ld: Tensor, s0: Optional[Tensor],
                    do: Tensor, dS_final: Optional[Tensor], *, inclusive: bool = True,
                    chunk: int = 64
                    ) -> tuple[Tensor, Tensor, Tensor, Tensor, Optional[Tensor]]:
    """Gradients of ``gla_chunked(q, k, v, ld, s0)`` for the output gradient
    ``do`` (B, L, H, dv) and the final state's ``dS_final`` (B, H, dk, dv) or
    None (the flow paths discard the final state).

    v: (B, L, H, dv); q, k: (B, L, H, dk), or (B, L, 1, dk) for one group
    broadcast over the H heads (their gradients are then summed over the
    heads); ld: (B, L, H, dk) or (B, L, H, 1) (one decay a head, its gradient
    summed over dk); s0: None or (B, H, dk, dv). Returns (dq, dk, dv, dld,
    ds0) in the shapes and dtypes of the inputs (ds0 None without s0).
    Computed in f32 (f64 for f64 q).
    """
    B, L, Hq, dk = q.shape
    H, dv = v.shape[2], v.shape[3]
    acc = torch.float64 if q.dtype == torch.float64 else torch.float32
    c = min(chunk, L)
    pad = (-L) % c
    n_chunks = (L + pad) // c

    def chunks(a, width):                               # (N, B, H, c, width)
        a = a.to(acc).expand(B, L, H, width)
        if pad:
            a = F.pad(a, (0, 0, 0, 0, 0, pad))
        return a.reshape(B, n_chunks, c, H, width).permute(1, 0, 3, 2, 4)

    qc, kc, ldc = chunks(q, dk), chunks(k, dk), chunks(ld, dk)
    vc, doc = chunks(v, dv), chunks(do, dv)
    idx = torch.arange(c, device=q.device)
    tri = idx[:, None] >= idx[None, :] if inclusive else idx[:, None] > idx[None, :]

    # each chunk's starting state, as the forward carries it
    S = (torch.zeros((B, H, dk, dv), dtype=acc, device=q.device) if s0 is None
         else s0.to(acc))
    starts = []
    for i in range(n_chunks):
        starts.append(S)
        cum = torch.cumsum(ldc[i], dim=2)
        cum_end = cum[:, :, -1:, :]
        S = (torch.exp(cum_end[:, :, 0, :, None]) * S
             + torch.einsum("bhsd,bhsv->bhdv", kc[i] * torch.exp(cum_end - cum), vc[i]))

    dS = (torch.zeros((B, H, dk, dv), dtype=acc, device=q.device) if dS_final is None
          else dS_final.to(acc))
    run = (dS * S).sum(-1)                              # sum_{t' > t} dL/db_t', (B, H, dk)
    q_next = torch.zeros_like(run)                      # q * dq at the later chunk's row 0
    parts = []
    for i in reversed(range(n_chunks)):
        q_, k_, v_, ld_, do_ = qc[i], kc[i], vc[i], ldc[i], doc[i]
        cum = torch.cumsum(ld_, dim=2)
        cum_q = cum if inclusive else cum - ld_
        cum_end = cum[:, :, -1:, :]
        # e^{min(cum_q[t] - cum[s], 0)} under the mask, (B, H, t, s, dk)
        E = torch.exp((cum_q[:, :, :, None, :] - cum[:, :, None, :, :]).clamp(max=0.0))
        E = torch.where(tri[:, :, None], E, 0.0)
        dP = do_ @ v_.transpose(-1, -2)                 # do_t . v_s, (B, H, t, s)
        P = torch.einsum("bhtd,bhsd,bhtsd->bhts", q_, k_, E)
        dq = (torch.exp(cum_q) * torch.einsum("bhtv,bhdv->bhtd", do_, starts[i])
              + torch.einsum("bhts,bhsd,bhtsd->bhtd", dP, k_, E))
        k_decay = torch.exp(cum_end - cum)
        dk_ = (torch.einsum("bhts,bhtd,bhtsd->bhsd", dP, q_, E)
               + k_decay * torch.einsum("bhdv,bhsv->bhsd", dS, v_))
        dv_ = (P.transpose(-1, -2) @ do_
               + torch.einsum("bhsd,bhdv->bhsv", k_ * k_decay, dS))
        qdq = q_ * dq
        if not inclusive:                               # o_{t+1} reads S_t
            qdq, q_next = torch.cat([qdq[:, :, 1:], q_next[:, :, None]], dim=2), qdq[:, :, 0]
        db = qdq - k_ * dk_
        dld = torch.flip(torch.cumsum(torch.flip(db, [2]), dim=2), [2]) + run[:, :, None]
        run = dld[:, :, 0]
        dS = (torch.exp(cum_end[:, :, 0, :, None]) * dS
              + torch.einsum("bhtd,bhtv->bhdv", q_ * torch.exp(cum_q), do_))
        parts.append((dq, dk_, dv_, dld))

    def unchunk(i):                                     # (B, L, H, width)
        a = torch.stack([p[i] for p in reversed(parts)])
        return a.permute(1, 0, 3, 2, 4).reshape(B, L + pad, H, a.shape[-1])[:, :L]

    dq, dk_, dv_, dld = (unchunk(i) for i in range(4))
    if Hq != H:
        dq, dk_ = dq.sum(2, keepdim=True), dk_.sum(2, keepdim=True)
    if ld.shape[-1] != dk:
        dld = dld.sum(-1, keepdim=True)
    ds0 = None if s0 is None else dS.to(s0.dtype)
    return dq.to(q.dtype), dk_.to(k.dtype), dv_.to(v.dtype), dld.to(ld.dtype), ds0
