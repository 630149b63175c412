"""Test samplers and engines speaking the serving protocols, for the
gateway suites.

The port's copy of ``repro.serving.toy``: ``FakeClock``; the flow toys
``ToyAnytimeSampler`` and ``CountingToySampler``, which speak the budget
protocol (``budgets``, ``resolve_budget``, ``sample_from``,
``sample_all_from``) AND the carry protocol (``carry_start``,
``carry_extend``) over the analytic two-moons velocity field, in torch on the
CPU; and ``ToyDecodeEngine`` (numpy) for the decode gateway. The reference's
``jit=True`` mode has no twin: the port's toys always run eagerly, so their
``on_forward`` hook fires on every batch-level velocity evaluation.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import ns_solver, schedulers, toy
from repro_torch.core.anytime import (
    AnytimeCarry,
    AnytimeParams,
    anytime_carry,
    anytime_extend,
    anytime_sample,
    extract_ns,
    init_anytime,
)
from repro_torch.serving.engine import nearest_budget


class FakeClock:
    """Deterministic clock for gateway simulation: ``gateway.clock`` is any
    zero-arg callable, so tests and benchmarks advance time explicitly (or
    from an engine/sampler forward hook) instead of sleeping."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def advance(self, seconds: float) -> None:
        self.t += seconds


class ToyAnytimeSampler:
    """Budget+carry-protocol sampler over the analytic toy field, on the CPU.

    The anytime solver is ``init_anytime`` + per-leaf Gaussian jitter drawn
    from a CPU generator seeded with ``seed``, so two instances with the
    same (budgets, seed, jitter) are bit-identical — the flush-vs-continuous
    comparisons rest on that. ``theta`` replaces the jittered solver (the
    parity tests pass the reference's, whose jitter comes from JAX keys).
    """

    def __init__(self, budgets: Sequence[int] = (4, 8, 16), seed: int = 0,
                 jitter: float = 0.1, theta: Optional[AnytimeParams] = None):
        self.budgets = tuple(sorted(budgets))
        if theta is None:
            gen = torch.Generator().manual_seed(seed)
            theta = AnytimeParams(*(
                leaf + jitter * torch.randn(leaf.shape, generator=gen)
                for leaf in init_anytime(None, self.budgets, "nested")))
        self.theta = theta
        self.field = toy.mixture_field(schedulers.fm_ot(), toy.two_moons_means(),
                                       torch.full((16,), 0.15), torch.ones((16,)))

    def on_forward(self) -> None:
        """Called once per batch-level velocity evaluation. Override to
        count forwards or advance a simulated clock."""

    def _u(self, t, x: torch.Tensor) -> torch.Tensor:
        self.on_forward()
        return self.field.fn(t, x)

    @staticmethod
    def _x0(x0) -> torch.Tensor:
        return torch.as_tensor(x0, dtype=torch.float32)

    # -- budget protocol -----------------------------------------------------

    def resolve_budget(self, m: int, strict: bool = False) -> int:
        return nearest_budget(self.budgets, m, strict)

    def sample_from(self, batch, x0, budget: int) -> torch.Tensor:
        ns = extract_ns(self.theta, self.budgets, budget)
        with torch.no_grad():
            return ns_solver.ns_sample(ns, self._u, self._x0(x0))

    def sample_all_from(self, batch, x0) -> dict[int, torch.Tensor]:
        with torch.no_grad():
            return anytime_sample(self.theta, self.budgets, self._u, self._x0(x0))

    # -- carry protocol (continuous batching) --------------------------------

    def carry_start(self, batch, x0) -> AnytimeCarry:
        return anytime_carry(self.theta, self.budgets, self._x0(x0))

    def carry_extend(self, batch, carry: AnytimeCarry, stop: int):
        with torch.no_grad():
            return anytime_extend(self.theta, self.budgets, self._u, carry, stop)


class CountingToySampler(ToyAnytimeSampler):
    """Variant metering batch-level backbone forwards — the NFE accounting
    the gateway tests assert against."""

    def __init__(self, budgets: Sequence[int] = (2, 4), seed: int = 0,
                 jitter: float = 0.1, theta: Optional[AnytimeParams] = None):
        super().__init__(budgets=budgets, seed=seed, jitter=jitter, theta=theta)
        self.forwards = 0

    def on_forward(self) -> None:
        self.forwards += 1


class ToyDecodeEngine:
    """Slot-protocol toy engine for the decode gateway (``init_slot_state``,
    ``step_slots``, ``reset_slots`` — what ``DecodeGateway`` needs), for the
    decode-gateway tests.

    The "model" is a deterministic affine map over the vocabulary,
    ``next = (a * token + b + position) % vocab`` — row-independent like the
    real backbones, and position-dependent so positional bugs (a joiner
    inheriting a freed slot's stale index) change the emitted tokens. State
    is just the per-slot position vector; everything runs in numpy, so the
    ``on_step`` hook (fake clock / wall-step counting) fires exactly once
    per engine INVOCATION (decode step or prefill call) with zero compile
    noise — ``prefill_slots`` consumes a whole chunk of prompt tokens per
    row in ONE invocation, which is exactly the wall-step saving chunked
    prefill buys. Greedy only (``supports_sampling = False``).

    ``page_size > 0`` makes the engine SPEAK the paged protocol (``paged``
    property, ``with_block_table`` no-op) without simulating page contents
    — the position-vector state is already O(1) per slot. The gateway's
    ``PageAllocator`` bookkeeping (reservation, head-of-line blocking,
    free-on-finish, peak tracking) then runs for real against the toy
    workload.
    """

    supports_sampling = False

    def __init__(self, vocab: int = 97, a: int = 31, b: int = 7,
                 on_step: Optional[Callable[[], None]] = None,
                 page_size: int = 0):
        self.vocab, self.a, self.b = vocab, a, b
        self.on_step = on_step
        self.page_size = page_size
        self.steps = 0

    @property
    def paged(self) -> bool:
        return self.page_size > 0

    def init_slot_state(self, slots: int, cache_slots: int, dtype=None,
                        total_pages: Optional[int] = None):
        return np.zeros((slots,), np.int64)        # per-slot position

    def with_block_table(self, state, table):
        return state                               # nothing paged to route

    def _tick(self) -> None:
        self.steps += 1
        if self.on_step is not None:
            self.on_step()

    def step_slots(self, token, state, active):
        self._tick()
        token = np.asarray(token, np.int64)
        active = np.asarray(active)
        nxt = (self.a * token + self.b + state) % self.vocab
        return nxt.astype(np.int32), np.where(active, state + 1, state)

    def prefill_slots(self, tokens, lengths, state, mask):
        """Chunked prefill: one engine invocation advances each masked
        row's position by its (teacher-forced) token count — predictions
        during prefill are discarded, so only the position moves."""
        self._tick()
        lengths = np.asarray(lengths, np.int64)
        return np.where(np.asarray(mask), state + lengths, state)

    def reset_slots(self, state, free):
        return np.where(np.asarray(free), 0, state)

    def solo_tokens(self, prompt, max_tokens: int,
                    stop_token: Optional[int] = None) -> list[int]:
        """Reference: decode one sequence alone (the bit-identity oracle
        for slot-refill tests)."""
        out: list[int] = []
        pos, tok = 0, int(prompt[0])
        fed = 1
        while True:
            nxt = (self.a * tok + self.b + pos) % self.vocab
            pos += 1
            if fed < len(prompt):
                tok = int(prompt[fed])
                fed += 1
                continue
            if stop_token is not None and nxt == stop_token:
                return out
            out.append(int(nxt))
            if len(out) >= max_tokens:
                return out
            tok = int(nxt)
