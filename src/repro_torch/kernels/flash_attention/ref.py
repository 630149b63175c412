"""Plain PyTorch versions of the attention kernels (twins of the reference's
``attention_ref`` and ``paged_attention_ref``)."""
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
