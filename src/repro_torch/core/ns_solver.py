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

import numpy as np
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

    Step i hands ``update_fn`` only the i + 1 velocities computed so far,
    ``U[:i+1]``, and the weights ``b[i, :i+1]`` (the reference passes the
    whole buffer with the later weights masked to zero, which adds nothing).
    ``a`` and ``b`` are made f32 once, before the loop, and stay on x0's
    device, so no step synchronises or launches anything besides ``u_fn`` and
    the update. How ``U[:i+1]`` is made depends on autograd:

    * ``torch.is_grad_enabled()`` false (every serving engine samples under
      ``torch.no_grad()``): the velocity buffer U (n, *x0.shape) is
      preallocated once, step i writes ``U[i] = u`` in place and hands over
      the view ``U[:i+1]``.
    * grad enabled: nothing is written in place, since step i's update saved
      ``U[:i+1]`` for backward; the velocities are kept in a list and step i
      hands over ``torch.stack`` of them (i + 1 rows, a copy). Sampling is then
      reverse-mode differentiable in a, b, x0 and whatever ``u_fn`` reads, as
      the reference's ``lax.scan`` is; on the card the update's backward is
      the ``ns_update`` backward kernel (``ops.NSUpdate``).
    """
    if update_fn is None:
        update_fn = fused_ns_update
    n = params.n
    dev = x0.device
    times, a, b = params.to(dev)
    a = a.to(torch.float32)
    b = torch.where(tril_mask(n, dev), b, 0.0).to(torch.float32)
    x = x0
    if torch.is_grad_enabled():
        us = []
        for i in range(n):
            us.append(u_fn(times[i], x))
            x = update_fn(x0, torch.stack(us), a[i], b[i, : i + 1])
        return x
    U = x0.new_zeros((n,) + tuple(x0.shape))     # a DTensor where x0 is one
    for i in range(n):
        U[i] = u_fn(times[i], x)
        x = update_fn(x0, U[: i + 1], a[i], b[i, : i + 1])
    return x


def ns_trajectory(
    params: NSParams, u_fn: Callable[[Tensor, Tensor], Tensor], x0: Tensor
) -> Tensor:
    """Like ``ns_sample`` but returns all trajectory points (n+1, ...).

    The update is the plain weighted sum over the velocities so far, as in
    the reference (which uses no kernel here)."""
    n = params.n
    dev = x0.device
    times, a, b = params.to(dev)
    b = torch.where(tril_mask(n, dev), b, 0.0)
    xs, us = [x0], []
    x = x0
    for i in range(n):
        us.append(u_fn(times[i], x))
        x = a[i] * x0 + torch.tensordot(b[i, : i + 1], torch.stack(us), dims=1)
        xs.append(x)
    return torch.stack(xs)


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


def count_parameters(n: int) -> int:
    """Paper's parameter count for an n-step NS solver: n(n+5)/2 + 1."""
    return n * (n + 5) // 2 + 1


def ns_params_from_numpy(times, a, b, device="cpu") -> NSParams:
    """``NSParams`` from the reference's arrays as numpy (``np.asarray`` of
    each field), f32 on ``device``."""
    return NSParams(*(torch.tensor(np.asarray(x, np.float32), device=device)
                      for x in (times, a, b)))


def bns_params_from_numpy(time_logits, a, b, device="cpu") -> BNSParams:
    """``BNSParams`` from the reference's arrays as numpy, f32 on ``device``."""
    return BNSParams(*(torch.tensor(np.asarray(x, np.float32), device=device)
                       for x in (time_logits, a, b)))
