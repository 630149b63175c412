"""Non-Stationary (NS) solvers — the paper's core object (Sec. 3.1).

Port of ``repro.core.ns_solver``. An n-step NS solver is a time grid of
evaluation times ``t_0 <= ... <= t_{n-1}`` plus per-step update rules in the
canonical form of Prop. 3.1:

    x_{i+1} = x0 * a_i + sum_{j<=i} b_{ij} u_j,      u_j = u_{t_j}(x_j)

Algorithm 1 (sampling) is a Python loop over the n steps, where the reference
uses ``lax.scan``.

Two representations:
  * ``NSParams``  — the solver itself (times (n,), a (n,), b (n,n) lower-tri).
  * ``BNSParams`` — an unconstrained reparameterization used for optimization
    (times via softmax-cumsum so the grid stays monotone in [0,1)).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.kernels.ns_update.ops import fused_ns_update

Tensor = torch.Tensor


class NSParams(NamedTuple):
    """Canonical NS solver parameters.

    times: (n,) evaluation times, t_0 = 0, non-decreasing, < 1.
    a:     (n,) coefficient of x0 per update rule.
    b:     (n, n) velocity coefficients; row i uses entries j <= i only.
    """

    times: Tensor
    a: Tensor
    b: Tensor

    @property
    def n(self) -> int:
        return self.a.shape[0]

    def num_parameters(self) -> int:
        """Paper's p = n(n+5)/2 + 1: grid (n+1 with both endpoints pinned ->
        n-1 free) + n a's + n(n+1)/2 b's. We count as the paper does."""
        n = self.n
        return n * (n + 5) // 2 + 1

    def to(self, device) -> "NSParams":
        return NSParams(*(p.to(device) for p in self))


def tril_mask(n: int, device=None) -> Tensor:
    return torch.tril(torch.ones((n, n), dtype=torch.bool, device=device))


def ns_sample(
    params: NSParams,
    u_fn: Callable[[Tensor, Tensor], Tensor],
    x0: Tensor,
    *,
    update_fn: Callable[..., Tensor] | None = None,
) -> Tensor:
    """Algorithm 1: sample with an NS solver.

    x0: (..., d) initial noise. u_fn(t, x) -> velocity over the whole batch.
    ``update_fn(x0, U, a_i, w_i) -> x_{i+1}`` computes each step's update; the
    default is ``kernels.ns_update.ops.fused_ns_update``, which launches the
    CUDA kernel for tensors on the card and runs its plain version on the CPU.

    Unlike the reference's immutable scan carry, the velocity buffer
    U (n, *x0.shape) is preallocated once and step i writes ``U[i] = u`` in
    place; rows past step i stay zero and their weights are masked to zero.
    ``a_i`` and ``w_i`` stay on x0's device, so no step synchronises.
    """
    if update_fn is None:
        update_fn = fused_ns_update
    n = params.n
    dev = x0.device
    times, a, b = params.to(dev)
    b = torch.where(tril_mask(n, dev), b, 0.0)
    steps = torch.arange(n, device=dev)
    U = torch.zeros((n,) + tuple(x0.shape), dtype=x0.dtype, device=dev)
    x = x0
    for i in range(n):
        U[i] = u_fn(times[i], x)
        w = torch.where(steps <= i, b[i], 0.0)
        x = update_fn(x0, U, a[i], w)
    return x


# ---------------------------------------------------------------------------
# Optimization reparameterization (BNS)
# ---------------------------------------------------------------------------


class BNSParams(NamedTuple):
    """Unconstrained parameterization of NSParams for gradient optimization.

    time_logits: (n,) — softmax gives n positive increments d_i summing to 1;
        eval times are t_0 = 0, t_i = d_0 + ... + d_{i-1}  (so t_{n-1} < 1).
    a, b: unconstrained; b is masked to lower-triangular on materialization.
    """

    time_logits: Tensor
    a: Tensor
    b: Tensor


def materialize(p: BNSParams) -> NSParams:
    d = torch.softmax(p.time_logits, dim=0)
    t = torch.cat([torch.zeros((1,), dtype=d.dtype, device=d.device),
                   torch.cumsum(d, 0)[:-1]])
    mask = tril_mask(p.a.shape[0], p.b.device)
    return NSParams(times=t, a=p.a, b=torch.where(mask, p.b, 0.0))


def from_ns(params: NSParams) -> BNSParams:
    """Inverse of ``materialize`` (up to softmax shift): init BNS from any NS solver."""
    t = params.times
    gaps = torch.diff(torch.cat([t, torch.ones((1,), dtype=t.dtype, device=t.device)]))
    logits = torch.log(torch.clamp(gaps, min=1e-8))
    return BNSParams(time_logits=logits, a=params.a, b=params.b)
