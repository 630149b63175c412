"""BNS solver training — Algorithm 2 of the paper.

Port of ``repro.core.bns``. Pipeline:
  1. generate (x0, x(1)) pairs with adaptive RK45 from the frozen model;
  2. initialize theta from a generic solver (optionally sigma0-preconditioned
     via a Scale-Time scheduler change, eq. 14) converted to NS parameters;
  3. minimize the PSNR loss  L(theta) = E log ||x_n^theta - x(1)||^2  with
     Adam, tracking PSNR on a validation set and returning the best iterate.

Each iteration is one program, as the reference jits it (``TrainLoop``):
the mini-batch gathered on the device, ``ns_sample`` under grad,
``torch.autograd.grad`` for theta's gradient and ``adam_update_`` in place,
the learning rate gathered from the run's table at Adam's counted step. On
the card it is one
CUDA graph, captured at the first iteration and replayed for every later
one (``serving/programs.py::ProgramCache``), and the validation is another;
the gradient flows through the backward kernels of the NS update and of
flash attention. On the CPU, and on the card under ``programs.disabled()``
(``jax.disable_jit()``), the same code runs eagerly. Validation samples
under ``torch.no_grad()``, which takes ``ns_sample``'s in-place buffer path.

The same harness trains BST solvers (the prior-work baseline) by swapping
the sampler closure: ``bst_sampler`` runs the BST program directly
(``taxonomy.run_direct``), so its training launches no ``ns_update``.
``make_distributed_bns_step`` is the data-parallel step over a mesh: the
pairs split over the batch axes, theta and Adam's state replicated, the
gradients averaged over the data group.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.core import bst_solver, ns_solver, st_transform
from repro_torch.core.ns_solver import BNSParams, NSParams
from repro_torch.core.parametrization import VelocityField
from repro_torch.core.rk45 import RK45Program, rk45_solve
from repro_torch.core.taxonomy import run_direct
from repro_torch.optim.adam import (
    adam_init,
    adam_update,
    adam_update_,
    tree_leaves,
    tree_map,
    tree_unflatten,
)
from repro_torch.optim.schedule import cosine_annealing, poly_decay, schedule_table

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
    integrate to x(1) with RK45, ``batch_size`` at a time, under no_grad,
    through one ``RK45Program`` (chunks of one shape share its program)."""
    program = RK45Program(field.fn, generator.device)
    x0s, x1s = [], []
    for start in range(0, num, batch_size):
        b = min(batch_size, num - start)
        x0 = source_std * torch.randn((b,) + tuple(shape), generator=generator,
                                      device=generator.device)
        x1s.append(rk45_solve(field.fn, x0, rtol=rtol, atol=atol, program=program).x1)
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


def bst_sampler(field: VelocityField, base: str = "euler"):
    prog = (bst_solver.bst_euler_program if base == "euler"
            else bst_solver.bst_midpoint_program)

    def sample(theta: bst_solver.BSTParams, x0: Tensor) -> Tensor:
        return run_direct(prog, field, x0, bst_solver.materialize_bst(theta))

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
    # each iteration's seconds and the run's program counts (see ``fit``);
    # attributes, not fields, so that the fields stay the reference's
    iteration_seconds = ()
    programs = {"programs": 0, "replays": 0, "capture_ms": 0.0}


def psnr(x: Tensor, ref: Tensor, max_val: float = 1.0) -> Tensor:
    """Per-pair PSNR with the paper's norm ||x||^2 = mean_i x_i^2."""
    mse = torch.mean((x - ref) ** 2, dim=tuple(range(1, x.dim())))
    # a fill on mse's device, not a host copy (a CUDA graph captures psnr)
    log_max = torch.log10(torch.full((), max_val, dtype=mse.dtype, device=mse.device))
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
    return fit(*solver_objective(sampler, val_pairs, cfg), theta0, train_pairs, cfg, log=log,
               line=lambda it, loss, vp: f"iter {it}: loss={loss:.4f} val_psnr={vp:.2f}dB")


def solver_objective(sampler: Callable, val_pairs, cfg: BNSTrainConfig):
    """``train_solver``'s ``loss_fn(theta, x0b, x1b)``, the PSNR loss of
    ``sampler``, and ``val_psnr_fn(theta)``, its mean val PSNR (0-d)."""
    def val_psnr_fn(theta) -> Tensor:
        return torch.mean(psnr(sampler(theta, val_pairs[0]), val_pairs[1], cfg.max_val))

    return (lambda th, x0, x1: _loss_fn(sampler, th, x0, x1)), val_psnr_fn


def batch_table(seed: int, num: int, batch_size: int, iterations: int,
                device) -> Tensor | None:
    """Every iteration's mini-batch rows, drawn up front in the reference's
    order (``np.random.default_rng(seed).choice(num, batch_size,
    replace=False)`` once an iteration), as one int64 ``(iterations,
    batch_size)`` tensor on ``device``; None for a full-batch run, which
    draws nothing and keeps the pairs' order (conditional fields close over
    a fixed conditioning batch: row i of the pairs is tied to its row i)."""
    if batch_size >= num:
        return None
    rng = np.random.default_rng(seed)
    rows = [rng.choice(num, size=batch_size, replace=False) for _ in range(iterations)]
    return torch.from_numpy(np.asarray(rows, np.int64).reshape(iterations, batch_size)
                            ).to(device)


class _Stamps:
    """Marks between iterations: CUDA events recorded on the current stream
    of a card (read once, at the end), the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.device = device
        self.marks: list = []
        self.mark()

    def mark(self) -> None:
        if self.device.type == "cuda":
            event = torch.cuda.Event(enable_timing=True)
            event.record(torch.cuda.current_stream(self.device))
            self.marks.append(event)
        else:
            self.marks.append(time.perf_counter())

    def seconds(self) -> list[float]:
        if self.device.type != "cuda":
            return [b - a for a, b in zip(self.marks, self.marks[1:])]
        self.marks[-1].synchronize()
        return [a.elapsed_time(b) / 1e3 for a, b in zip(self.marks, self.marks[1:])]


class TrainLoop:
    """One Algorithm-2 run's state and its two programs, the port's form of
    the reference's jitted ``step`` and ``val_psnr_fn``.

    theta (a detached copy of ``theta0`` on the pairs' device) and Adam's
    ``mu``, ``nu`` and ``step`` keep their addresses for the whole run;
    ``step()`` updates them in place and returns the loss, ``validate()``
    returns the val PSNR of theta as it stands, a 0-d tensor. Both go
    through one ``ProgramCache``: on the card the first ``step()`` is
    iteration 0, run eagerly as the capture's warm-up, and every later one
    replays the captured graph; likewise ``validate()``. A step takes no
    host input: its mini-batch is row ``step`` (Adam's count so far, the
    reference's ``it``) of the run's ``batch_table`` and its learning rate
    entry ``step`` of ``rates``, both gathered on the device. ``rates``
    holds ``cfg``'s schedule at every iteration, computed up front on the
    host as the reference's ``lr_fn(it)`` (f32 arithmetic on the card would
    round the division differently) and copied once. A field of theta the
    loss does not reach gets a zero gradient, as ``jax.grad`` gives it."""

    def __init__(self, loss_fn: Callable, val_psnr_fn: Callable, theta0, train_pairs,
                 cfg: BNSTrainConfig):
        # function-level import: the serving package imports this module back
        from repro_torch.serving.programs import ProgramCache

        self.loss_fn, self.val_psnr_fn, self.cfg = loss_fn, val_psnr_fn, cfg
        self.pairs = train_pairs
        device = train_pairs[0].device
        self.theta = tree_map(lambda p: p.detach().to(device, copy=True), theta0)
        self.opt = adam_init(self.theta)
        lr_fn = (poly_decay(cfg.lr, cfg.iterations) if cfg.lr_schedule == "poly"
                 else cosine_annealing(cfg.lr, cfg.iterations))
        self.rates = schedule_table(lr_fn, cfg.iterations, device)
        self.batches = batch_table(cfg.seed, train_pairs[0].shape[0], cfg.batch_size,
                                   cfg.iterations, device)
        self.programs = ProgramCache(device)
        self._state = tuple(tree_leaves((self.theta, self.opt)))

    def _step(self) -> Tensor:
        theta, opt = self.theta, self.opt
        x0, x1 = self.pairs
        if self.batches is not None:
            rows = self.batches.index_select(0, opt.step.reshape(1)).reshape(-1)
            x0, x1 = x0.index_select(0, rows), x1.index_select(0, rows)
        th = tree_map(lambda p: p.detach().requires_grad_(True), theta)
        loss = self.loss_fn(th, x0, x1)
        leaves = tree_leaves(th)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = tree_unflatten(th, [torch.zeros_like(p) if g is None else g
                                    for p, g in zip(leaves, grads)])
        lr = self.rates.index_select(0, opt.step.reshape(1)).reshape(())
        with torch.no_grad():
            adam_update_(grads, opt, theta, lr)
        return loss.detach()

    def step(self) -> Tensor:
        """One iteration; returns its loss (0-d, on the device)."""
        return self.programs(("step",), self._step, state=self._state)

    def validate(self) -> Tensor:
        """theta's val PSNR (0-d, on the device), under ``torch.no_grad()``."""
        with torch.no_grad():
            return self.programs(("val",), lambda: self.val_psnr_fn(self.theta))

    def run(self, *, log: Callable[[str], None] | None = None,
            line: Callable[[int, float, float], str]) -> TrainResult:
        """``cfg.iterations`` steps, ``validate()`` every ``cfg.val_every``
        and at the last (the host reads the loss and the val PSNR only
        then), logged through ``line(iteration, loss, val_psnr)``; returns
        the best-validation theta (``bns.fit``)."""
        cfg = self.cfg
        best = (-np.inf, self.theta)
        history = []
        t_start = time.time()
        stamps = _Stamps(self.pairs[0].device)
        for it in range(cfg.iterations):
            loss = self.step()
            if (it + 1) % cfg.val_every == 0 or it == cfg.iterations - 1:
                vp = float(self.validate())
                history.append((it + 1, float(loss), vp))
                if vp > best[0]:
                    best = (vp, tree_map(lambda x: x.detach().clone(), self.theta))
                if log:
                    log(line(it + 1, float(loss), vp))
            stamps.mark()
        seconds = stamps.seconds()
        n_params = sum(int(np.prod(p.shape)) for p in tree_leaves(best[1]))
        res = TrainResult(params=best[1], val_psnr=best[0], history=history,
                          wall_seconds=time.time() - t_start, nfe=cfg.nfe,
                          num_parameters=n_params)
        res.iteration_seconds, res.programs = seconds, self.programs.stats()
        return res


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
    ``loss_fn(theta, x0b, x1b)`` over mini-batches of the train pairs and
    ``val_psnr_fn(theta)`` (a 0-d tensor) under ``torch.no_grad()`` every
    ``cfg.val_every`` iterations and at the last, through one ``TrainLoop``
    (its docstring: one captured program for the step and one for the
    validation on the card, replayed; eager on the CPU). Returns the
    best-validation theta; the loop's programs are dropped on return, so a
    process that distils many solvers keeps none of their graphs.

    ``iteration_seconds`` holds each iteration's span, its validation
    included where it ran one: on the card, between CUDA events recorded
    on the stream after each iteration and read at the end, so no
    synchronisation is added and each span is the iteration's device work
    once the host runs ahead (iteration 0 also holds the host's capture,
    during which the card waits); on the CPU, the host clock.
    ``programs`` holds the run's captured programs, replays and capture ms
    (0 on the CPU)."""
    return TrainLoop(loss_fn, val_psnr_fn, theta0, train_pairs, cfg).run(log=log, line=line)


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


def make_distributed_bns_step(field: VelocityField, cfg: BNSTrainConfig, mesh):
    """The Algorithm-2 step over ``mesh`` (a ``DeviceMesh`` with ("data",
    "model") or ("pod", "data", "model") axes), the twin of the reference's
    pjit'd step.

    BNS training is data-parallel: each rank takes its rows of the (x0, x1)
    pairs along the composed batch axes (a DTensor is redistributed to that
    split; a plain tensor is the whole batch, the same on every rank, and
    each rank slices its rows), theta (<200 floats) and the Adam state are
    replicated, and the gradient and the loss are summed over each batch
    axis's process group and divided by the number of shards: the mean of
    equal shards' mean losses is the whole batch's mean. A batch axis of one
    rank runs no collective. The learning rate is ``lr_fn(it)`` computed on
    the host, as ``TrainLoop`` does. The backbone inside ``field`` runs on
    each rank's own copy of its weights. theta and Adam's state lie on the
mesh's device. Returns (step_fn, theta0, opt0);
    ``step_fn(theta, opt, it, x0b, x1b) -> (theta, opt, loss)``."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import batch_axes
    from repro_torch.solvers.registry import build_ns

    names = tuple(mesh.mesh_dim_names)
    axes = [names.index(a) for a in batch_axes(mesh)]
    sizes = [mesh.size(i) for i in axes]
    groups = [mesh.get_group(i) for i, n in zip(axes, sizes) if n > 1]
    parts = 1
    shard = 0                      # this rank's index along the composed axes
    coord = mesh.get_coordinate()
    for i, n in zip(axes, sizes):
        parts *= n
        shard = shard * n + coord[i]
    sampler = ns_sampler(field)
    lr_fn = (poly_decay(cfg.lr, cfg.iterations) if cfg.lr_schedule == "poly"
             else cosine_annealing(cfg.lr, cfg.iterations))

    def local_rows(x: Tensor) -> Tensor:
        if type(x) is not torch.Tensor and hasattr(x, "device_mesh"):
            from torch.distributed.tensor import Replicate, Shard

            return x.redistribute(mesh, [Shard(0) if d in axes else Replicate()
                                         for d in range(len(names))]).to_local()
        if x.shape[0] % parts:
            raise ValueError(f"a batch of {x.shape[0]} pairs does not split over "
                             f"{parts} data shards")
        n = x.shape[0] // parts
        return x[shard * n:(shard + 1) * n]

    def step(theta, opt, it, x0b, x1b):
        x0, x1 = local_rows(x0b), local_rows(x1b)
        th = tree_map(lambda p: p.detach().requires_grad_(True), theta)
        loss = _loss_fn(sampler, th, x0, x1)
        leaves = tree_leaves(th)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, torch.autograd.grad(loss, leaves, allow_unused=True))]
        loss = loss.detach()
        if groups:
            flat = torch.cat([g.reshape(-1) for g in grads] + [loss.reshape(1)])
            for group in groups:
                dist.all_reduce(flat, group=group)
            flat = flat / parts
            grads = list(torch.split(flat[:-1], [g.numel() for g in grads]))
            grads = [g.reshape(p.shape) for g, p in zip(grads, leaves)]
            loss = flat[-1]
        lr = torch.tensor(float(lr_fn(int(it))), dtype=torch.float32, device=loss.device)
        with torch.no_grad():
            theta, opt = adam_update(tree_unflatten(theta, grads), opt, theta, lr)
        return theta, opt, loss

    device = (torch.device("cuda", torch.cuda.current_device())
              if mesh.device_type == "cuda" else torch.device(mesh.device_type))
    ns0 = build_ns(cfg.init_solver, cfg.nfe, field, sigma0=cfg.sigma0)
    theta0 = tree_map(lambda p: p.detach().to(device, copy=True), ns_solver.from_ns(ns0))
    return step, theta0, adam_init(theta0)


def train_bst(
    field: VelocityField,
    train_pairs,
    val_pairs,
    cfg: BNSTrainConfig,
    *,
    base: str = "euler",
    log=None,
) -> TrainResult:
    if cfg.sigma0 != 1.0:
        target = st_transform.scaled_sigma(field.scheduler, cfg.sigma0)
        st = st_transform.scheduler_change_st(field.scheduler, target)
        theta0 = bst_solver.from_st_transform(st, cfg.nfe, base)
    else:
        theta0 = bst_solver.identity_bst(cfg.nfe, base)
    return train_solver(bst_sampler(field, base), theta0, train_pairs, val_pairs,
                        cfg, log=log)
