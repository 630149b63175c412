"""Plain PyTorch version of the NS update kernel (twin of the reference's ref.py)."""
import torch


def ns_update_ref(x0: torch.Tensor, u: torch.Tensor, a: torch.Tensor,
                  w: torch.Tensor) -> torch.Tensor:
    """x0: (B, ...); u: (n, B, ...); a scalar; w: (n,). Sums in f32, returns x0's dtype."""
    acc = a.to(torch.float32) * x0.to(torch.float32)
    acc = acc + torch.tensordot(w.to(torch.float32), u.to(torch.float32),
                                dims=([0], [0]))
    return acc.to(x0.dtype)
