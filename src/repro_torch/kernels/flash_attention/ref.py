"""Plain PyTorch version of the flash attention kernel (twin of the reference's
``attention_ref``)."""
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
