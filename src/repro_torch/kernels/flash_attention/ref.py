"""Plain PyTorch versions of the attention kernels (twins of the reference's
``attention_ref`` and ``paged_attention_ref``), and of the flash backward."""
import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True) -> torch.Tensor:
    """q: (B, H, Lq, hd); k, v: (B, KV, Lk, hd). f32 scores, mask -1e30,
    softmax, output in q's dtype."""
    B, H, Lq, hd = q.shape
    KV, Lk = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, KV, G, Lq, hd).to(torch.float32) * hd**-0.5
    s = torch.einsum("bkgqh,bksh->bkgqs", qg, k.to(torch.float32))
    if causal:
        mask = (torch.arange(Lq, device=q.device)[:, None]
                >= torch.arange(Lk, device=q.device)[None, :])
        s = torch.where(mask, s, -1e30)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bksh->bkgqh", w, v.to(torch.float32))
    return o.reshape(B, H, Lq, hd).to(q.dtype)


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                      causal: bool = True):
    """The flash backward's formulas in f32: (dq, dk, dv) for the output
    gradient ``do``, from the forward's output ``o`` and per-row log-sum-exp
    ``lse`` (B, H, Lq).

    D = rowsum(dO * O); P = exp(S scale - lse) (0 where masked);
    dV = sum over the group of P^T dO; dS = P * (dO V^T - D);
    dK = scale * sum over the group of dS^T Q; dQ = scale * dS K.
    q, o, do: (B, H, Lq, hd); k, v: (B, KV, Lk, hd); results in q's dtype.
    """
    B, H, Lq, hd = q.shape
    KV, Lk = k.shape[1], k.shape[2]
    G = H // KV
    scale = hd ** -0.5
    f = lambda t, n: t.to(torch.float32).reshape(B, KV, G, n, hd)  # noqa: E731
    qf, of, dof = f(q, Lq), f(o, Lq), f(do, Lq)
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    s = torch.einsum("bkgqh,bksh->bkgqs", qf, kf) * scale
    p = torch.exp(s - lse.reshape(B, KV, G, Lq, 1))
    if causal:
        mask = (torch.arange(Lq, device=q.device)[:, None]
                >= torch.arange(Lk, device=q.device)[None, :])
        p = torch.where(mask, p, 0.0)
    dsum = (dof * of).sum(-1, keepdim=True)
    dp = torch.einsum("bkgqh,bksh->bkgqs", dof, vf)
    ds = p * (dp - dsum)
    dv = torch.einsum("bkgqs,bkgqh->bksh", p, dof)
    dk = torch.einsum("bkgqs,bkgqh->bksh", ds, qf) * scale
    dq = torch.einsum("bkgqs,bksh->bkgqh", ds, kf) * scale
    return (dq.reshape(B, H, Lq, hd).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))


def attention_lse_ref(q: torch.Tensor, k: torch.Tensor, *, causal: bool = True) -> torch.Tensor:
    """Each query row's natural log-sum-exp of its scaled, masked scores,
    (B, H, Lq) f32: what the forward kernel writes for the backward."""
    B, H, Lq, hd = q.shape
    KV, Lk = k.shape[1], k.shape[2]
    qg = q.reshape(B, KV, H // KV, Lq, hd).to(torch.float32) * hd**-0.5
    s = torch.einsum("bkgqh,bksh->bkgqs", qg, k.to(torch.float32))
    if causal:
        mask = (torch.arange(Lq, device=q.device)[:, None]
                >= torch.arange(Lk, device=q.device)[None, :])
        s = torch.where(mask, s, -1e30)
    return torch.logsumexp(s, dim=-1).reshape(B, H, Lq)


def paged_attention_ref(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                        block_table: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Dense-gather version of the paged decode kernel.

    q: (B, KV, G, hd); k_pages/v_pages: (num_pages, page_size, KV, hd);
    block_table: (B, nb) page ids; lengths: (B,) valid positions per row.
    f32 scores, positions >= length masked with -1e30, softmax, output in q's
    dtype.
    """
    B, KV, G, hd = q.shape
    ps = k_pages.shape[1]
    nb = block_table.shape[1]
    table = block_table.long()
    # (B, nb, ps, KV, hd) -> (B, nb*ps, KV, hd): row b's logical positions
    k = k_pages[table].reshape(B, nb * ps, KV, hd).to(torch.float32)
    v = v_pages[table].reshape(B, nb * ps, KV, hd).to(torch.float32)
    qf = q.to(torch.float32) * hd ** -0.5
    s = torch.einsum("bkgh,bskh->bkgs", qf, k)
    valid = torch.arange(nb * ps, device=q.device)[None, :] < lengths[:, None]
    s = torch.where(valid[:, None, None, :], s, -1e30)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskh->bkgh", w, v)
    return o.to(q.dtype)
