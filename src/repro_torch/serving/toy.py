"""Numpy-only test engines for the decode gateway's logic.

The port's copy of ``FakeClock`` and ``ToyDecodeEngine`` from
``repro.serving.toy``; the flow toys (``ToyAnytimeSampler``,
``CountingToySampler``) come with the flow gateway tiers (ROADMAP Queue A
item 7).
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np


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
