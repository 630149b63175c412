"""BNS solver training — Algorithm 2 of the paper.

Port of ``repro.core.bns``. Pipeline:
  1. generate (x0, x(1)) pairs with adaptive RK45 from the frozen model;
  2. initialize theta from a generic solver converted to NS parameters;
  3. minimize the PSNR loss  L(theta) = E log ||x_n^theta - x(1)||^2  with
     Adam, tracking PSNR on a validation set and returning the best iterate.

Each step runs eagerly (the reference jits it): ``ns_sample`` under grad,
``torch.autograd.grad`` for theta's gradient, and ``adam_update`` under
``torch.no_grad()``. On the card the gradient flows through the backward
kernels of the NS update and of flash attention. Validation samples under
``torch.no_grad()``, which takes ``ns_sample``'s in-place buffer path. The
BST sampler and ``train_bst`` come with ROADMAP Queue A item 2,
``make_distributed_bns_step`` with item 8.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.core import ns_solver
from repro_torch.core.ns_solver import BNSParams, NSParams
from repro_torch.core.parametrization import VelocityField
from repro_torch.core.rk45 import rk45_solve
from repro_torch.optim.adam import adam_init, adam_update, tree_leaves, tree_map, tree_unflatten
from repro_torch.optim.schedule import cosine_annealing, poly_decay

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Ground-truth pair generation
# ---------------------------------------------------------------------------


def generate_pairs(
    field: VelocityField,
    generator: torch.Generator,
    num: int,
    shape: tuple[int, ...],
    *,
    batch_size: int = 64,
    rtol: float = 1e-5,
    atol: float = 1e-5,
    source_std: float = 1.0,
) -> tuple[Tensor, Tensor]:
    """Draw x0 ~ N(0, source_std^2) with ``generator`` (on its device) and
    integrate to x(1) with RK45, ``batch_size`` at a time, under no_grad."""
    x0s, x1s = [], []
    for start in range(0, num, batch_size):
        b = min(batch_size, num - start)
        x0 = source_std * torch.randn((b,) + tuple(shape), generator=generator,
                                      device=generator.device)
        with torch.no_grad():
            x1s.append(rk45_solve(field.fn, x0, rtol=rtol, atol=atol).x1)
        x0s.append(x0)
    return torch.cat(x0s), torch.cat(x1s)


# ---------------------------------------------------------------------------
# Initialization (generic solver -> NS params)
# ---------------------------------------------------------------------------


def solver_to_ns(
    name: str,
    nfe: int,
    field: VelocityField,
    *,
    sigma0: float = 1.0,
    grid=None,
) -> NSParams:
    """DEPRECATED shim over ``repro_torch.solvers.registry.build_ns``, kept
    as the reference keeps it; use ``build_ns`` directly."""
    import warnings

    from repro_torch.solvers.registry import build_ns

    warnings.warn("solver_to_ns is deprecated; use repro_torch.solvers.build_ns",
                  DeprecationWarning, stacklevel=2)
    return build_ns(name, nfe, field, sigma0=sigma0, grid=grid)


def ns_sampler(field: VelocityField) -> Callable[[BNSParams, Tensor], Tensor]:
    def sample(theta: BNSParams, x0: Tensor) -> Tensor:
        return ns_solver.ns_sample(ns_solver.materialize(theta), field.fn, x0)

    return sample


# ---------------------------------------------------------------------------
# Algorithm 2
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class BNSTrainConfig:
    nfe: int = 8
    init_solver: str = "midpoint"
    sigma0: float = 1.0
    lr: float = 5e-4
    lr_schedule: str = "poly"        # "poly" | "cosine" (paper: poly for class-cond, cosine for T2I/audio)
    iterations: int = 2000
    batch_size: int = 40
    val_every: int = 100
    seed: int = 0
    max_val: float = 1.0             # PSNR peak value (1.0 for unit-scale latents)


@dataclasses.dataclass
class TrainResult:
    params: object                   # best-validation parameters (detached)
    val_psnr: float
    history: list                    # (iter, train_loss, val_psnr)
    wall_seconds: float
    nfe: int
    num_parameters: int
    # each iteration's host-clock seconds (see ``fit``); an attribute, not a
    # field, so that the fields stay the reference's
    iteration_seconds = ()


def psnr(x: Tensor, ref: Tensor, max_val: float = 1.0) -> Tensor:
    """Per-pair PSNR with the paper's norm ||x||^2 = mean_i x_i^2."""
    mse = torch.mean((x - ref) ** 2, dim=tuple(range(1, x.dim())))
    log_max = torch.log10(torch.tensor(max_val, dtype=mse.dtype, device=mse.device))
    return 10.0 * (2.0 * log_max - torch.log10(torch.clamp(mse, min=1e-20)))


def _loss_fn(sampler, theta, x0, x1):
    xh = sampler(theta, x0)
    mse = torch.mean((xh - x1) ** 2, dim=tuple(range(1, x0.dim())))
    return torch.mean(torch.log(torch.clamp(mse, min=1e-20)))


def train_solver(
    sampler: Callable,
    theta0,
    train_pairs: tuple[Tensor, Tensor],
    val_pairs: tuple[Tensor, Tensor],
    cfg: BNSTrainConfig,
    *,
    log: Callable[[str], None] | None = None,
) -> TrainResult:
    """Generic Algorithm-2 optimizer over any differentiable sampler.

    theta lives on the pairs' device. Mini-batch indices come from
    ``np.random.default_rng(cfg.seed)`` exactly as in the reference, so both
    frameworks train on the same batches."""
    def val_psnr_fn(theta) -> float:
        return float(torch.mean(psnr(sampler(theta, val_pairs[0]), val_pairs[1],
                                     cfg.max_val)))

    return fit(lambda th, x0, x1: _loss_fn(sampler, th, x0, x1), val_psnr_fn, theta0,
               train_pairs, cfg, log=log,
               line=lambda it, loss, vp: f"iter {it}: loss={loss:.4f} val_psnr={vp:.2f}dB")


def fit(
    loss_fn: Callable,
    val_psnr_fn: Callable,
    theta0,
    train_pairs: tuple[Tensor, Tensor],
    cfg: BNSTrainConfig,
    *,
    log: Callable[[str], None] | None = None,
    line: Callable[[int, float, float], str],
) -> TrainResult:
    """Algorithm 2's loop, shared by ``train_solver`` and
    ``anytime.train_anytime`` (the reference writes it out in each): Adam on
    ``loss_fn(theta, x0b, x1b)`` over mini-batches of the train pairs, each
    step eager (``torch.autograd.grad``, then ``adam_update`` under
    ``torch.no_grad()``); ``val_psnr_fn(theta)`` under ``torch.no_grad()``
    every ``cfg.val_every`` iterations and at the last, logged through
    ``line(iteration, loss, val_psnr)``; returns the best-validation theta.
    A field of theta the loss does not reach gets a zero gradient, as
    ``jax.grad`` gives it. ``iteration_seconds`` holds each iteration's
    host-clock time, from its mini-batch's arrival on the pairs' device to
    the next one's (the last: to the end of its validation). On the card
    that copy from pageable memory waits for the work queued before it, so
    each span holds the iteration's device work, and a validation where the
    iteration ran one, with no synchronisation added."""
    x0_tr, x1_tr = train_pairs
    num = x0_tr.shape[0]
    lr_fn = (poly_decay(cfg.lr, cfg.iterations) if cfg.lr_schedule == "poly"
             else cosine_annealing(cfg.lr, cfg.iterations))

    def step(theta, opt, it, x0b, x1b):
        th = tree_map(lambda p: p.detach().requires_grad_(True), theta)
        loss = loss_fn(th, x0b, x1b)
        leaves = tree_leaves(th)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = tree_unflatten(th, [torch.zeros_like(p) if g is None else g
                                    for p, g in zip(leaves, grads)])
        with torch.no_grad():
            theta, opt = adam_update(grads, opt, theta, lr_fn(it))
        return theta, opt, loss.detach()

    theta = tree_map(lambda p: p.detach().to(x0_tr.device), theta0)
    opt = adam_init(theta)
    rng = np.random.default_rng(cfg.seed)
    best = (-np.inf, theta)
    history, starts = [], []
    t_start = time.time()
    full_batch = cfg.batch_size >= num
    for it in range(cfg.iterations):
        # conditional fields close over a fixed conditioning batch: row i of
        # the pairs is tied to conditioning row i, so full-batch runs must
        # keep the order (no shuffling).
        idx = np.arange(num) if full_batch else \
            rng.choice(num, size=cfg.batch_size, replace=False)
        idx = torch.as_tensor(idx, device=x0_tr.device)
        starts.append(time.perf_counter())
        theta, opt, loss = step(theta, opt, it, x0_tr[idx], x1_tr[idx])
        if (it + 1) % cfg.val_every == 0 or it == cfg.iterations - 1:
            with torch.no_grad():
                vp = val_psnr_fn(theta)
            history.append((it + 1, float(loss), vp))
            if vp > best[0]:
                best = (vp, tree_map(lambda x: x.detach().clone(), theta))
            if log:
                log(line(it + 1, float(loss), vp))
    starts.append(time.perf_counter())
    n_params = sum(int(np.prod(p.shape)) for p in tree_leaves(best[1]))
    res = TrainResult(params=best[1], val_psnr=best[0], history=history,
                      wall_seconds=time.time() - t_start, nfe=cfg.nfe,
                      num_parameters=n_params)
    res.iteration_seconds = [b - a for a, b in zip(starts, starts[1:])]
    return res


def train_bns(
    field: VelocityField,
    train_pairs,
    val_pairs,
    cfg: BNSTrainConfig,
    *,
    log=None,
) -> TrainResult:
    from repro_torch.solvers.registry import build_ns

    ns0 = build_ns(cfg.init_solver, cfg.nfe, field, sigma0=cfg.sigma0)
    theta0 = ns_solver.from_ns(ns0)
    res = train_solver(ns_sampler(field), theta0, train_pairs, val_pairs, cfg, log=log)
    # Report the paper's parameter count (canonical dimension of the family).
    res.num_parameters = ns_solver.count_parameters(cfg.nfe)
    return res
