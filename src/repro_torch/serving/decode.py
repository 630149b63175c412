"""Decode-side gateway: continuous batching over ``DecodeEngine``.

Port of ``repro.serving.decode``. Where it differs from the reference:
sampled requests draw their noise from per-sequence torch generators seeded
``fold_in(base seed, uid)`` and per step ``fold_in(seed, count)``
(``serving.engine.fold_in``) where the reference folds threefry keys, with
the same property (tokens depend only on base seed, uid and step). With
``mesh=`` the engine's weights and the slot state are placed on the serving
mesh (``serving.sharded.shard_params`` and ``place_decode_state``: a paged
pool's KV heads on ``model``, the block table and positions replicated), and
the paged kernel runs on each rank's local shard.

The flow gateways batch the paper's BNS sampler; this module batches the
serving stack's SECOND engine — autoregressive decode with KV-cache /
recurrent state. Callers ``submit`` a ``DecodeRequest(prompt, max_tokens)``
and get a ``Future[DecodeResponse]``; the gateway multiplexes every accepted
sequence onto the rows of ONE fixed-slot batched decode state
(``DecodeEngine.init_slot_state``), so each engine step costs one backbone
forward for the whole slot batch regardless of how many sequences ride it.

Continuous slot refill
----------------------
* Each sequence owns a STATE SLOT: one row of the batched KV/recurrent
  state, at its own decode position (the per-row ``index`` vector — the
  decode twin of the flow gateway's trajectory slots, with per-slot write masks instead
  of exit boundaries).
* A sequence finishing (``max_tokens`` reached or ``stop_token`` emitted)
  resolves its future immediately and FREES its slot; queued sequences are
  admitted into freed slots at the very next engine step — the batch never
  drains to empty before refilling (run-to-completion batching does, and
  pays ``max(lengths)`` wall-steps per wave; see ``refill=False`` and
  the reference's ``benchmarks/decode_bench.py``).
* Rows are independent through the backbone and each row carries its own
  position, so a sequence admitted into a freed slot produces tokens
  BIT-IDENTICAL to decoding it alone (MoE: in the no-capacity-drop regime,
  as for batched decode generally).

Chunked batched prefill
-----------------------
Prompts are fed through ``engine.prefill_slots``: every pump tick runs at
most ONE prefill call covering up to ``prefill_chunk`` prompt tokens for
ALL prefilling rows at once, then one decode step over the rows that are
past their prompt. A 100-token prompt therefore costs ~``100/chunk`` engine
invocations instead of 100 decode-step ticks, and sequences mid-generation
keep emitting every tick while long prompts stream in beside them. Chunk
widths are bucketed to powers of two, so a serving session runs at most
``log2(prefill_chunk)`` distinct prefill shapes: on the card, one captured
CUDA graph each beside the step's (``serving.programs``), captured inside
``pump``'s ``_plan_lock`` and the process's dispatch lock
(``gateway.EXEC_LOCK``) like every engine call, so no other thread, of this
gateway or of a fleet's other hosts, launches work during a capture.
``prefill_chunk=0`` restores the
legacy token-by-token teacher-forced feed (the decode benchmark's
comparison baseline). The prefill scan body is the same ``decode_apply``
as ``step_slots``, so generated tokens are bit-identical either way.

Paged KV cache
--------------
A paged engine (``DecodeEngine(page_size=N)``) swaps the dense
``(slots, cache_slots, ...)`` cache rows for a shared page pool plus a
per-row block table (``PagedKVCache``). The gateway owns the
``PageAllocator``: admission reserves ``ceil((P + max_tokens - 1) /
page_size)`` pages up front (FIFO head-of-line blocking when the pool runs
short — a sequence never starts unless it can finish), finish/cancel/fail
returns them, and every free immediately resets the row so its stale block
table points back at the reserved trash page 0 before the freed pages can
be reallocated. Resident KV memory therefore tracks ACTUAL sequence
lengths, not ``max_slots * cache_slots`` worst case — the pool can be
sized to the expected load (``total_pages``) and admission degrades to
queueing, never to corruption.

Sampling
--------
``DecodeRequest.sampling`` (a ``SamplingParams``) switches a sequence from
greedy to temperature / top-k / top-p sampling. Randomness is seeded per
SEQUENCE as ``fold_in(base_seed, uid)`` and per STEP by folding in the
emitted-token count, so a request's tokens depend only on (base seed, uid,
step): reproducible across restarts and batch compositions
(``GatewayBase.federate`` shares the base seed fleet-wide).
Mixed batches cost one program — greedy rows ride the sampled step at
temperature 0, which is an exact argmax.

Stop conditions are per slot: ``max_tokens`` caps generation (finish_reason
``"length"``), ``stop_token`` ends it early (``"stop"``; the stop token is
not included in the returned tokens). A CANCELLED future releases its slot
(and pages) at the next pump instead of decoding to completion — cancelled
sequences count under ``cancelled``, never ``completed``/``tokens_out``.

Stats ride the shared ``GatewayStats``: ``forwards`` counts engine
invocations (prefill calls + decode steps — the wall-step unit),
``prefill_calls``/``prefill_tokens`` the chunked-prefill share,
``tokens_out``/``tokens_per_s`` the generated tokens (settled futures
only), ``slot_occupancy`` the active-slot share of every step taken;
``trajectories`` counts engine-batch lifetimes (idle -> busy -> idle) and
``joins`` the sequences admitted while other slots were mid-flight — the
continuous-refill events. Paged gateways add ``pages_in_use`` /
``peak_pages`` / ``page_size`` to the ``stats()`` snapshot.

``GatewayBase`` supplies intake, the serve-thread lifecycle, drain (waits on
in-flight sequences, not just queue depth), and the ``stats()`` snapshot.
"""
from __future__ import annotations

import dataclasses
import time
from concurrent.futures import Future
from typing import Any, Callable, Optional, Sequence, Union

import numpy as np

from repro_torch.observability import profile_span
from repro_torch.serving.engine import SlotSampling, fold_in
from repro_torch.serving.gateway import EXEC_LOCK, GatewayBase, mesh_scope
from repro_torch.serving.slo import urgency_key
from repro_torch.serving.stream import StreamSink


@dataclasses.dataclass
class DecodeRequest:
    """One user's decode request: prompt tokens (at least one; fed
    teacher-forced), a generation cap, an optional stop token, and optional
    ``SamplingParams`` (None = greedy)."""

    prompt: Union[Sequence[int], np.ndarray]
    max_tokens: int = 16
    stop_token: Optional[int] = None
    sampling: Optional[Any] = None      # repro_torch.serving.engine.SamplingParams
    # opt-in: attach the recorded lifecycle trace to the DecodeResponse
    trace: bool = False
    # SLO: relative deadline (ms from submit; None = best-effort) and
    # priority (higher first under an SLOConfig; 0 = default)
    deadline_ms: Optional[float] = None
    priority: int = 0
    # per-token streaming (use submit_stream, which sets this)
    stream: bool = False


@dataclasses.dataclass
class DecodeResponse:
    """Generated tokens plus serving metadata.

    ``meta`` records: finish_reason ("length" | "stop"), prompt_len,
    new_tokens, steps (engine steps this sequence was resident for =
    backbone forwards it shared), slot, join_step (engine step at
    admission; > 0 means the sequence joined an in-flight batch), wait_ms
    (queue time — waits end at admission).
    """

    tokens: np.ndarray
    meta: dict
    trace: Optional[list] = None    # recorded lifecycle (opt-in)


class PageAllocator:
    """Host-side free list over the shared KV page pool.

    Page 0 is RESERVED as the trash page: freed/inactive rows' block tables
    point at it, so the writes they still make inside the fixed-shape step
    land harmlessly instead of corrupting reallocated pages. The
    allocator hands out pages 1..total-1; ``peak`` tracks the high-water
    mark (the benchmark's resident-memory gauge)."""

    def __init__(self, total_pages: int):
        if total_pages < 2:
            raise ValueError("total_pages must be >= 2 (page 0 is the "
                             "reserved trash page)")
        self.total = total_pages
        self._free = list(range(total_pages - 1, 0, -1))  # pop() -> page 1 first
        self.peak = 0

    @property
    def available(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return (self.total - 1) - len(self._free)

    def alloc(self, n: int) -> list[int]:
        if n > len(self._free):
            raise RuntimeError(
                f"page pool exhausted: need {n}, have {len(self._free)}")
        pages = [self._free.pop() for _ in range(n)]
        self.peak = max(self.peak, self.in_use)
        return pages

    def free(self, pages: Sequence[int]) -> None:
        self._free.extend(pages)

    def bind(self, registry) -> None:
        """Register lazy gauges into the owning gateway's metrics
        registry — page accounting already lives here, so the registry
        reads it at snapshot time instead of double-booking each
        alloc/free."""
        registry.gauge("pages_in_use",
                       "KV pages allocated out of the shared pool") \
            .set_fn(lambda: self.in_use)
        registry.gauge("peak_pages",
                       "high-water KV pages in use").set_fn(lambda: self.peak)
        registry.gauge("page_pool_total",
                       "allocatable pages (total minus trash page 0)") \
            .set_fn(lambda: self.total - 1)


@dataclasses.dataclass
class _DecodeEntry:
    uid: int
    prompt: np.ndarray
    max_tokens: int
    stop_token: Optional[int]
    t_submit: float
    future: Future
    sampling: Optional[Any] = None
    t_admit: Optional[float] = None
    join_step: int = 0          # engine step at admission (0 = opened batch)
    trace: bool = False         # attach the recorded lifecycle on finish
    deadline: Optional[float] = None    # absolute, on the gateway clock
    priority: int = 0
    sink: Optional[Any] = None          # StreamSink when streaming


@dataclasses.dataclass
class _Slot:
    """Host bookkeeping for one occupied state row: the sequence it serves,
    how much of its prompt has been fed, what it has generated, and (paged)
    which pool pages it owns."""

    entry: _DecodeEntry
    pos: int = 1                # prompt tokens already fed (incl. pending feed)
    emitted: list = dataclasses.field(default_factory=list)
    pages: list = dataclasses.field(default_factory=list)

    @property
    def prefilling(self) -> bool:
        return self.pos < len(self.entry.prompt)


class DecodeGateway(GatewayBase):
    """Continuous-batching front-end over one ``DecodeEngine``.

    ``submit(DecodeRequest) -> Future[DecodeResponse]``; ``pump()`` is one
    engine tick: admit queued sequences into free slots, release cancelled
    ones, run at most one chunked-prefill call over the rows still
    consuming their prompts, then one write-masked decode step over the
    rows past them (``engine.step_slots``) and advance each active
    sequence. ``start()``/``drain()``/``shutdown()`` come from
    ``GatewayBase``; the unit tests
    drive ``pump`` directly with a fake clock.

    ``refill=False`` degrades admission to run-to-completion batching (new
    sequences wait until EVERY slot is free) — the baseline the decode
    benchmark gates continuous refill against. ``prefill_chunk=0`` degrades
    prefill to the legacy token-by-token teacher-forced feed.

    The engine only needs the slot protocol (``init_slot_state``,
    ``step_slots``, ``reset_slots``, plus ``prefill_slots`` when
    ``prefill_chunk > 0`` and ``with_block_table`` when paged) —
    ``DecodeEngine`` for real backbones, ``repro_torch.serving.toy.
    ToyDecodeEngine`` for deterministic simulation.
    """

    _request_type = DecodeRequest       # submit_stream builds these

    def __init__(self, engine, *, max_slots: int = 8, cache_slots: int = 128,
                 dtype=None, refill: bool = True, prefill_chunk: int = 64,
                 total_pages: Optional[int] = None, seed: Optional[int] = None,
                 mesh=None,
                 clock: Callable[[], float] = time.monotonic,
                 metrics=None, recorder=None, slo=None):
        if max_slots < 1:
            raise ValueError("max_slots must be >= 1")
        if prefill_chunk < 0:
            raise ValueError("prefill_chunk must be >= 0 (0 = token-by-token)")
        if getattr(getattr(engine, "cfg", None), "family", None) == "encdec":
            # encdec decode cross-attends per-sequence ENCODER MEMORY the
            # slot protocol has no hook to supply (init_slot_state zero-
            # fills it) — serving would silently produce garbage tokens
            raise TypeError(
                "DecodeGateway cannot serve encoder-decoder engines: the "
                "slot state has no per-request encoder memory; decode "
                "encdec batches through DecodeEngine.greedy with a "
                "prefilled state instead")
        super().__init__(clock=clock, metrics=metrics, recorder=recorder,
                         slo=slo)
        self.engine = engine
        self.max_slots = max_slots
        self.refill = refill
        self.prefill_chunk = prefill_chunk
        # non-windowed KV-cache families clamp writes past the cache's last
        # physical slot (silently degraded tokens) — reject over-length
        # requests at submit instead (None = unbounded: ring buffer,
        # recurrent state, toy engines)
        self._capacity = (cache_slots
                          if getattr(engine, "seq_capacity_bounded", False)
                          else None)
        self._paged = bool(getattr(engine, "paged", False))
        self._alloc: Optional[PageAllocator] = None
        state_kw: dict[str, Any] = {} if dtype is None else {"dtype": dtype}
        if self._paged:
            ps = engine.page_size
            if cache_slots % ps:
                raise ValueError(
                    f"cache_slots ({cache_slots}) must be a multiple of "
                    f"page_size ({ps})")
            blocks = cache_slots // ps
            pages = (1 + max_slots * blocks) if total_pages is None \
                else total_pages
            self._alloc = PageAllocator(pages)
            self._alloc.bind(self.metrics)
            self._table = np.zeros((max_slots, blocks), np.int32)
            state_kw["total_pages"] = pages
        self._state = engine.init_slot_state(max_slots, cache_slots,
                                             **state_kw)
        self.mesh = mesh
        if mesh is not None:
            from repro_torch.serving import sharded
            from repro_torch.serving.programs import ProgramCache

            sharded.check_mesh(mesh)
            engine.params = sharded.shard_params(engine.params, engine.cfg, mesh)
            engine.programs = ProgramCache(engine.device)  # keyed on the placed weights
            self._state = sharded.place_decode_state(self._state, engine.cfg, mesh)
        self._slots: list[Optional[_Slot]] = [None] * max_slots
        self._feed = np.zeros((max_slots,), np.int32)   # next token per slot
        self._steps = 0                                  # engine steps run
        # per-slot sampling buffers (temperature 0 = greedy row)
        self._samp_seeds = np.zeros((max_slots,), np.uint64)
        self._temps = np.zeros((max_slots,), np.float32)
        self._top_ks = np.zeros((max_slots,), np.int32)
        self._top_ps = np.ones((max_slots,), np.float32)
        self._sampling_resident = 0
        if seed is not None:
            self._base_seed = seed
        elif getattr(engine, "supports_sampling", False):
            self._base_seed = 0
        else:
            self._base_seed = None

    # -- intake ---------------------------------------------------------------

    def submit(self, request: Optional[DecodeRequest] = None, **kw) -> Future:
        """Enqueue one sequence; returns a Future[DecodeResponse]."""
        if request is None:
            request = DecodeRequest(**kw)
        prompt = np.asarray(request.prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("prompt needs at least one token")
        if request.max_tokens < 1:
            raise ValueError("max_tokens must be >= 1")
        # worst-case positions used (length-finish): (P-1) prefill steps +
        # max_tokens generation steps write positions 0..P+T-2
        if (self._capacity is not None
                and prompt.size + request.max_tokens - 1 > self._capacity):
            raise ValueError(
                f"prompt ({prompt.size}) + max_tokens "
                f"({request.max_tokens}) exceeds the decode cache capacity "
                f"({self._capacity} slots); raise cache_slots or lower "
                "max_tokens")
        sampling = request.sampling
        if sampling is not None and sampling.temperature > 0 \
                and not getattr(self.engine, "supports_sampling", False):
            raise ValueError(
                "engine does not support sampling (greedy only); omit "
                "DecodeRequest.sampling or use temperature=0")
        t_submit = self.clock()
        entry = _DecodeEntry(uid=next(self._uid), prompt=prompt,
                             max_tokens=int(request.max_tokens),
                             stop_token=request.stop_token,
                             sampling=sampling,
                             t_submit=t_submit, future=Future(),
                             trace=request.trace,
                             deadline=(None if request.deadline_ms is None
                                       else t_submit
                                       + request.deadline_ms / 1e3),
                             priority=int(request.priority),
                             sink=StreamSink() if request.stream else None)
        self._check_admission(entry)
        return self._enqueue(entry)

    # -- engine tick ----------------------------------------------------------

    def pump(self, force: bool = False) -> int:
        """One engine tick: release cancelled sequences, admit into free
        slots, one chunked-prefill call (if any row is consuming its
        prompt), one masked decode step (if any row is past it)."""
        with self._plan_lock, EXEC_LOCK, mesh_scope(self.mesh):
            self._sweep_cancelled()
            if self.slo is not None:
                self._shed_expired()
            self._admit()
            did = 0
            if self.prefill_chunk:
                did = self._pump_prefill()
                if did and not any(s is not None and not s.prefilling
                                   for s in self._slots):
                    return 1        # every occupied row is still prefilling
            if self.prefill_chunk:
                active = np.array([s is not None and not s.prefilling
                                   for s in self._slots])
            else:
                active = np.array([s is not None for s in self._slots])
            if not active.any():
                return did
            sampling = self._slot_sampling() if self._sampling_resident else None
            t0 = self.clock()   # gateway clock: fake-clock benches feed the
            #                     SLO cost model simulated dispatch times
            try:
                with profile_span(f"decode.step.k{self.max_slots}"):
                    if sampling is None:
                        nxt, state = self.engine.step_slots(
                            self._feed.copy(), self._state, active)
                    else:
                        nxt, state = self.engine.step_slots(
                            self._feed.copy(), self._state, active,
                            sampling=sampling)
            except BaseException as exc:  # noqa: BLE001 — see _fail_slots
                self._fail_slots(exc)
                return 1
            step_ms = (self.clock() - t0) * 1e3
            self._state = state
            nxt = np.asarray(nxt)       # host tokens (the engine's or the toy's)
            self._steps += 1
            with self._stats_lock:
                m = self._m
                m.forwards.inc()         # one backbone forward per step
                m.batches.inc()
                m.real_rows.inc(int(active.sum()))
                m.padded_rows.inc(self.max_slots)
                m.slot_steps_active.inc(int(active.sum()))
                m.slot_steps_total.inc(self.max_slots)
                m.device_dispatch_ms.observe(step_ms)
                self._note_program(f"step/k{self.max_slots}")
            for i, slot in enumerate(self._slots):
                if slot is not None and active[i]:
                    self._advance_slot(i, slot, int(nxt[i]))
            return 1

    def _slot_sampling(self):
        """Assemble the per-slot ``SlotSampling`` arrays (copies of the
        live buffers, which change between pumps)."""
        counts = np.array([len(s.emitted) if s is not None else 0
                           for s in self._slots], np.int32)
        return SlotSampling(seeds=self._samp_seeds.copy(), counts=counts,
                            temps=self._temps.copy(),
                            top_ks=self._top_ks.copy(),
                            top_ps=self._top_ps.copy())

    def _pages_needed(self, entry: _DecodeEntry) -> int:
        ps = self.engine.page_size
        return -(-(len(entry.prompt) + entry.max_tokens - 1) // ps)

    def _sweep_cancelled(self) -> None:
        """Release slots whose futures the client cancelled — without this
        a cancelled sequence keeps decoding (and holding its row + pages)
        until max_tokens, starving the queue: the slot-leak fix."""
        rec = self.recorder
        for i, slot in enumerate(self._slots):
            if slot is not None and slot.entry.future.cancelled():
                self._release_slot(i, slot)
                with self._stats_lock:
                    self._m.cancelled.inc()
                    self._inflight -= 1       # taken at admission
                if rec:
                    rec.event(slot.entry.uid, "settle", self.clock(),
                              host=self._host, status="cancelled")

    def _admit(self) -> None:
        """Admit queued sequences (FIFO) into free slots: reset each freed
        row to the zero state, reserve pages (paged), and stage the prompt
        (first token fed next step, or chunked prefill from position 0).
        Admission is immediate — the latency win — unless ``refill=False``
        holds new sequences until the whole batch drains. A paged admission
        that cannot reserve its worst-case pages BLOCKS the queue head
        (FIFO) until finishes free pages, rather than skipping ahead."""
        free = [i for i, s in enumerate(self._slots) if s is None]
        busy = self.max_slots - len(free)
        if not free or (not self.refill and busy):
            return
        order = urgency_key if self.slo is not None else (lambda e: e.uid)
        pending = sorted(self.queue.snapshot(), key=order)
        dropped = [e for e in pending if e.future.cancelled()]
        if dropped:
            self._take(dropped)
            self._m.cancelled.inc(len(dropped))
            self._settle(len(dropped))
            pending = [e for e in pending if not e.future.cancelled()]
        admitted = []
        reserve = self._alloc.available if self._alloc is not None else 0
        for e in pending:
            if len(admitted) == len(free):
                break
            if self._alloc is not None:
                need = self._pages_needed(e)
                if need > reserve:
                    break               # head-of-line: keep FIFO order
                reserve -= need
            admitted.append(e)
        if not admitted:
            return
        self._take(admitted)
        assigned = list(zip(free, admitted))
        mask = np.zeros((self.max_slots,), bool)
        for i, _ in assigned:
            mask[i] = True
        self._state = self.engine.reset_slots(self._state, mask)
        now = self.clock()
        for i, e in assigned:
            e.t_admit, e.join_step = now, self._steps
            slot = _Slot(entry=e)
            if self._alloc is not None:
                slot.pages = self._alloc.alloc(self._pages_needed(e))
                self._table[i, :] = 0
                self._table[i, :len(slot.pages)] = slot.pages
            if self.prefill_chunk and len(e.prompt) > 1:
                slot.pos = 0            # chunked prefill feeds the prompt
            else:
                slot.pos = 1
                self._feed[i] = e.prompt[0]
            sp = e.sampling
            if sp is not None and sp.temperature > 0:
                self._samp_seeds[i] = fold_in(self._base_seed, e.uid)
                self._temps[i] = sp.temperature
                self._top_ks[i] = sp.top_k
                self._top_ps[i] = sp.top_p
                self._sampling_resident += 1
            else:
                self._samp_seeds[i] = 0
                self._temps[i], self._top_ks[i], self._top_ps[i] = 0, 0, 1.0
            self._slots[i] = slot
        if self._alloc is not None:
            self._state = self.engine.with_block_table(self._state,
                                                       self._table.copy())
        with self._stats_lock:
            m = self._m
            if busy:
                m.joins.inc(len(assigned))  # continuous refill mid-flight
            else:
                m.trajectories.inc()        # opened a fresh engine batch
        rec = self.recorder
        if rec:
            for i, e in assigned:
                rec.event(e.uid, "dispatch", now, host=self._host,
                          kind="admit", slot=i, join_step=e.join_step)

    def _pump_prefill(self) -> int:
        """One chunked-prefill engine call covering every row still
        consuming its prompt: row i is fed up to ``prefill_chunk`` of its
        remaining prompt tokens (all but the last — the decode step feeds
        that and emits the first token). Chunk widths are bucketed to
        powers of two to bound the distinct shapes."""
        need = [(i, s) for i, s in enumerate(self._slots)
                if s is not None and s.pos < len(s.entry.prompt) - 1]
        if not need:
            return 0
        longest = max(len(s.entry.prompt) - 1 - s.pos for _, s in need)
        width = 1
        while width < min(longest, self.prefill_chunk):
            width *= 2
        tokens = np.zeros((self.max_slots, width), np.int32)
        lengths = np.zeros((self.max_slots,), np.int32)
        mask = np.zeros((self.max_slots,), bool)
        for i, s in need:
            p = s.entry.prompt
            take = min(width, len(p) - 1 - s.pos)
            tokens[i, :take] = p[s.pos:s.pos + take]
            lengths[i] = take
            mask[i] = True
        t0 = self.clock()
        try:
            with profile_span(f"decode.prefill.w{width}"):
                self._state = self.engine.prefill_slots(tokens, lengths,
                                                        self._state, mask)
        except BaseException as exc:  # noqa: BLE001 — see _fail_slots
            self._fail_slots(exc)
            return 1
        prefill_ms = (self.clock() - t0) * 1e3
        with self._stats_lock:
            m = self._m
            m.forwards.inc()             # one engine invocation
            m.prefill_calls.inc()
            m.prefill_tokens.inc(int(lengths.sum()))
            m.device_dispatch_ms.observe(prefill_ms)
            self._note_program(f"prefill/w{width}")
        rec = self.recorder
        now = self.clock() if rec else 0.0
        for i, sl in need:
            sl.pos += int(lengths[i])
            p = sl.entry.prompt
            if sl.pos == len(p) - 1:     # prompt consumed: decode next tick
                self._feed[i] = p[-1]
                sl.pos = len(p)
                if rec:
                    rec.event(sl.entry.uid, "prefill", now, host=self._host,
                              prompt_len=int(len(p)))
        return 1

    def _advance_slot(self, si: int, slot: _Slot, tok: int) -> None:
        """Advance one active sequence given the model's prediction ``tok``
        for the token its row was just fed."""
        e = slot.entry
        if slot.pos < len(e.prompt):
            # legacy (prefill_chunk=0) path: the prediction is discarded,
            # the next prompt token is fed teacher-forced
            self._feed[si] = e.prompt[slot.pos]
            slot.pos += 1
            return
        if e.stop_token is not None and tok == e.stop_token:
            self._finish(si, slot, "stop")
            return
        slot.emitted.append(tok)
        if e.sink is not None:
            e.sink.partial(tok, index=len(slot.emitted) - 1)
        if len(slot.emitted) >= e.max_tokens:
            self._finish(si, slot, "length")
            return
        self._feed[si] = tok

    def _release_slot(self, si: int, slot: _Slot) -> None:
        """Free one slot's row (and pages). Paged rows are reset
        IMMEDIATELY: their stale block table would otherwise route the
        freed row's in-flight writes into pages the allocator may hand to
        the next admission — the reset points it back at trash page 0."""
        if self._alloc is not None:
            self._alloc.free(slot.pages)
            self._table[si, :] = 0
            mask = np.zeros((self.max_slots,), bool)
            mask[si] = True
            self._state = self.engine.reset_slots(self._state, mask)
        if self._temps[si] > 0:
            self._sampling_resident -= 1
        self._samp_seeds[si] = 0
        self._temps[si], self._top_ks[si], self._top_ps[si] = 0, 0, 1.0
        self._slots[si] = None

    def _finish(self, si: int, slot: _Slot, reason: str) -> None:
        """Resolve one sequence's future and free its slot — the next
        ``_admit`` can scatter a fresh sequence into the row. Stats count
        the sequence only if its future actually SETTLED: a future
        cancelled in the same tick must not inflate ``tokens_out`` or the
        wait aggregates (the stats-skew fix)."""
        e = slot.entry
        rec = self.recorder
        if rec:
            rec.event(e.uid, "settle", self.clock(), host=self._host,
                      status="completed", finish_reason=reason, slot=si)
        response = DecodeResponse(
            tokens=np.asarray(slot.emitted, np.int32),
            meta={
                "finish_reason": reason,
                "prompt_len": int(len(e.prompt)),
                "new_tokens": len(slot.emitted),
                "steps": self._steps - e.join_step,
                "slot": si,
                "join_step": e.join_step,
                "wait_ms": (e.t_admit - e.t_submit) * 1e3,
            })
        if e.trace and rec:
            response.trace = rec.trace(e.uid)
        try:
            e.future.set_result(response)
            settled = True
        except Exception:              # cancelled: the batch rolls on
            settled = False
        if e.sink is not None:
            e.sink.final(response)
        wait_ms = (e.t_admit - e.t_submit) * 1e3
        with self._stats_lock:
            m = self._m
            if settled:
                m.completed.inc()
                m.tokens_out.inc(len(slot.emitted))
                m.wait_ms.observe(wait_ms)
                self._note_deadline(e, self.clock())
            else:
                m.cancelled.inc()
            self._inflight -= 1        # taken at admission
        self._release_slot(si, slot)

    def _fail_slots(self, exc: BaseException) -> None:
        """Surface a failing engine call into every resident sequence's
        future and free all slots, keeping the serve thread alive (the
        decode twin of ``ContinuousGateway._fail_trajectory``). Freed rows
        hold stale state; admission resets them before reuse (and, paged,
        pushes a fresh block table)."""
        entries = [s.entry for s in self._slots if s is not None]
        self._fail_entries(entries, exc, count_all=True)
        self._settle(len(entries))
        if self._alloc is not None:
            for s in self._slots:
                if s is not None and s.pages:
                    self._alloc.free(s.pages)
            self._table[:] = 0
        self._samp_seeds[:] = 0
        self._temps[:], self._top_ks[:], self._top_ps[:] = 0, 0, 1.0
        self._sampling_resident = 0
        self._slots = [None] * self.max_slots

    # -- SLO cost model -------------------------------------------------------

    def _estimate_wait_ms(self, entry: _DecodeEntry) -> float:
        """Modeled completion time for a decode request: every engine tick
        costs one observed dispatch (``_dispatch_cost_ms``), the request
        itself needs ~``prompt + max_tokens`` ticks once resident, and each
        full wave of queued sequences ahead of it costs an average
        sequence length of ticks before a slot frees up."""
        cost = self._dispatch_cost_ms()
        with self._stats_lock:
            done = self._m.completed.value
            toks = self._m.tokens_out.value
        avg_len = (toks / done) if done else float(entry.max_tokens)
        waves = self.queue.depth() // self.max_slots
        own = len(entry.prompt) + entry.max_tokens
        return cost * (own + waves * avg_len)

    # -- metrics --------------------------------------------------------------

    def stats(self) -> dict[str, Any]:
        out = super().stats()
        if self._alloc is not None:
            ps = self.engine.page_size
            out["page_size"] = ps
            out["pages_in_use"] = self._alloc.in_use
            out["peak_pages"] = self._alloc.peak
            # high-water resident KV positions per slot — the paged-memory
            # win: bounded by actual sequence lengths, not cache_slots
            out["peak_kv_per_slot"] = self._alloc.peak * ps / self.max_slots
        return out
