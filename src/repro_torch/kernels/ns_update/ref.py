"""Plain PyTorch versions of the NS update kernel and its backward (twin of
the reference's ref.py; the backward is the reverse of the same weighted sum)."""
import torch

_DOT_WIDTH = 64     # columns: a multiple of the CPU BLAS's 16-wide blocks


def ns_update_ref(x0: torch.Tensor, u: torch.Tensor, a: torch.Tensor,
                  w: torch.Tensor) -> torch.Tensor:
    """x0: (B, ...); u: (n, B, ...); a scalar; w: (n,). Sums in f32, returns x0's dtype.

    The reference's one ``tensordot``, over ``u`` seen as (n, N) with N padded
    with zero columns to a multiple of ``_DOT_WIDTH``. On the CPU the BLAS
    computes an element by the same arithmetic wherever it lies, except in
    the last N mod 16 columns, which it sums otherwise (an ulp apart); with
    the padding no element lies there, so an element's value depends on its
    own inputs only, not on the batch or the positions around it — what the
    serving gateways promise when they pad batches and shape tiers."""
    n = u.shape[0]
    acc = a.to(torch.float32) * x0.to(torch.float32)
    uf = u.to(torch.float32).reshape(n, -1)
    N = uf.shape[1]
    if N % _DOT_WIDTH:
        uf = torch.nn.functional.pad(uf, (0, _DOT_WIDTH - N % _DOT_WIDTH))
    dot = torch.tensordot(w.to(torch.float32), uf, dims=([0], [0]))[:N]
    return (acc + dot.reshape(acc.shape)).to(x0.dtype)


def ns_update_bwd_ref(g: torch.Tensor, x0: torch.Tensor, u: torch.Tensor,
                      a: torch.Tensor, w: torch.Tensor, *, need_x0: bool = True):
    """Backward of ``ns_update_ref`` for the output gradient ``g``:
    (dx0 = a g or None, du_j = w_j g, da = <x0, g>, dw_j = <u_j, g>), products
    and sums in f32; dx0 and du in x0's and u's dtypes, da and dw in a's and
    w's."""
    gf = g.to(torch.float32)
    wf = w.to(torch.float32).reshape((-1,) + (1,) * g.dim())
    du = (wf * gf).to(u.dtype)
    dx0 = (a.to(torch.float32) * gf).to(x0.dtype) if need_x0 else None
    da = (x0.to(torch.float32) * gf).sum().reshape(a.shape).to(a.dtype)
    dw = torch.tensordot(u.to(torch.float32), gf, dims=g.dim()).to(w.dtype)
    return dx0, du, da, dw
