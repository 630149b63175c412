"""The gateway base the decode gateway serves through.

Port of the sampler-agnostic part of ``repro.serving.gateway``:
``GatewayBase`` (thread-safe intake, the serve-thread lifecycle, drain with
in-flight accounting, SLO admission and shedding, streaming, fleet hooks and
the locked ``stats()`` snapshot), its request queue, the one shared metric
schema (``METRIC_SCHEMA``) with its ``stats_projection`` view, ``HostLoad``
and ``DrainTimeout``. ``GatewayBase`` uses no JAX in the reference either.

The flow gateway (``Gateway``, ``BatchScheduler``, ``Batch``,
``assemble_rows``, the flow ``Request``/``Response``) and its continuous,
tiered and fleet tiers come with ROADMAP Queue A items 7 and 8.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, Optional, Sequence

from repro_torch.observability import NULL_RECORDER, MetricsRegistry
from repro_torch.serving.slo import (
    AdmissionRejected,
    DeadlineExceeded,
    SLOConfig,
    hist_mean,
    is_urgent,
    urgency_key,
)
from repro_torch.serving.stream import ResponseStream


class DrainTimeout(RuntimeError):
    """``drain(timeout=...)`` expired with work still unresolved. Carries
    the ``stats()`` projection taken at expiry, the full registry
    ``snapshot`` (queue-depth / in-flight gauges included), and the
    ``spans`` of every traced request that never settled — so a hung
    drain is diagnosable: a fleet host-leave logs WHAT was stuck and
    moves on instead of hanging the whole fleet behind one wedged
    engine."""

    def __init__(self, message: str, stats: dict,
                 snapshot: Optional[dict] = None,
                 spans: Optional[dict] = None):
        super().__init__(message)
        self.stats = stats
        self.snapshot = snapshot if snapshot is not None else {}
        self.spans = spans if spans is not None else {}


@dataclasses.dataclass(frozen=True)
class HostLoad:
    """Point-in-time load snapshot of one gateway (= one fleet queue
    shard): entries still queued and entries taken but unresolved. The
    work stealer balances on these — only ``queue_depth`` is stealable.
    ``urgent`` counts queued entries carrying SLO pressure (priority > 0
    or a deadline); the stealer prefers victims holding urgent work."""

    queue_depth: int
    inflight: int
    urgent: int = 0

    @property
    def total(self) -> int:
        return self.queue_depth + self.inflight


class RequestQueue:
    """Thread-safe FIFO of pending entries with a depth gauge."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: list = []

    def push(self, entry) -> None:
        with self._lock:
            self._entries.append(entry)

    def depth(self) -> int:
        with self._lock:
            return len(self._entries)

    def remove(self, taken: set) -> None:
        """Drop exactly the batched entries (by uid). Entries pushed while
        the scheduler was planning are untouched — never lost."""
        with self._lock:
            self._entries = [e for e in self._entries if e.uid not in taken]

    def snapshot(self) -> list:
        with self._lock:
            return list(self._entries)


@dataclasses.dataclass
class GatewayStats:
    """Legacy counter bundle, kept as a compatibility VIEW: the registry
    (``GatewayBase.metrics``) is the single source of truth and
    ``GatewayBase.stats_raw`` reconstructs this dataclass from it."""

    submitted: int = 0
    completed: int = 0
    failed: int = 0
    batches: int = 0
    mixed_batches: int = 0
    forwards: int = 0          # backbone forwards spent (batch-level NFE sum)
    real_rows: int = 0
    padded_rows: int = 0
    sum_wait_ms: float = 0.0
    max_wait_ms: float = 0.0
    started: float = 0.0
    # continuous batching (zero under the flush-only gateway):
    trajectories: int = 0      # anytime trajectories opened
    legs: int = 0              # boundary-to-boundary trajectory dispatches
    joins: int = 0             # requests admitted into in-flight trajectories
    join_forwards: int = 0     # forwards spent computing join prefixes
    slot_steps_active: int = 0  # occupied slot-steps across trajectory legs
    slot_steps_total: int = 0   # max_slots * steps across trajectory legs
    # decode serving (zero under the flow gateways):
    tokens_out: int = 0        # generated tokens delivered to clients
    cancelled: int = 0         # sequences dropped on a cancelled future
    prefill_calls: int = 0     # chunked-prefill engine invocations
    prefill_tokens: int = 0    # prompt tokens consumed by chunked prefill
    # fleet federation (zero outside a FleetGateway):
    stolen_in: int = 0         # queued entries migrated INTO this shard
    stolen_out: int = 0        # queued entries migrated OUT of this shard
    # SLO scheduling (zero without an SLOConfig / deadlines):
    rejected: int = 0          # fast-rejected by admission control
    preemptions: int = 0       # slots evicted at exit boundaries
    deadline_misses: int = 0   # deadline requests settled late or shed
    goodput: int = 0           # deadline requests completed on time


# The ONE shared metric schema every serving tier emits into. Counter
# names deliberately match the ``GatewayStats`` field names so the
# legacy view is a field-for-field read; the gauges/histograms are the
# telemetry the flat counters could not express. ``SolverZoo`` (zoo_*)
# and ``PageAllocator`` (pages_*/peak_pages) register their names into
# the same registry when bound to a gateway.
METRIC_SCHEMA: tuple = (
    ("submitted", "counter", "requests accepted by submit()"),
    ("completed", "counter", "requests resolved with a result"),
    ("failed", "counter", "requests resolved with an exception"),
    ("batches", "counter", "padded batches dispatched"),
    ("mixed_batches", "counter", "shared-trajectory mixed-budget batches"),
    ("forwards", "counter", "backbone forwards spent (batch-level NFE)"),
    ("real_rows", "counter", "real rows across dispatched batches"),
    ("padded_rows", "counter", "padded rows across dispatched batches"),
    ("trajectories", "counter", "anytime trajectories opened"),
    ("legs", "counter", "boundary-to-boundary trajectory dispatches"),
    ("joins", "counter", "requests admitted into in-flight work"),
    ("join_forwards", "counter", "forwards spent computing join prefixes"),
    ("slot_steps_active", "counter", "occupied slot-steps across legs"),
    ("slot_steps_total", "counter", "available slot-steps across legs"),
    ("tokens_out", "counter", "generated tokens delivered to clients"),
    ("cancelled", "counter", "sequences dropped on a cancelled future"),
    ("prefill_calls", "counter", "chunked-prefill engine invocations"),
    ("prefill_tokens", "counter", "prompt tokens consumed by prefill"),
    ("stolen_in", "counter", "queued entries migrated INTO this shard"),
    ("stolen_out", "counter", "queued entries migrated OUT of this shard"),
    ("rejected", "counter", "requests fast-rejected by admission control"),
    ("preemptions", "counter",
     "slots evicted at exit boundaries for urgent work"),
    ("deadline_misses", "counter",
     "deadline-carrying requests settled late or shed in queue"),
    ("goodput", "counter",
     "deadline-carrying requests completed before their deadline"),
    ("queue_depth", "gauge", "entries waiting in the intake queue"),
    ("inflight", "gauge", "entries taken off the queue, unresolved"),
    ("jit_programs", "gauge", "distinct jit programs dispatched "
                              "(a climb in steady state = retracing)"),
    ("tier_occupancy", "gauge",
     "native/padded position-row share of dispatched work, per shape "
     "tier (labelled tier=<shape>; the unlabelled base stays 0 — "
     "populated only when a ShapeLadder is configured)"),
    ("wait_ms", "histogram", "queue wait per settled request (ms)"),
    ("cost_est_error_ms", "histogram",
     "admission cost model calibration: |estimated - actual| settle "
     "time per deadline-carrying settled request (ms)"),
    ("host_assembly_ms", "histogram",
     "host-side batch assembly + transfer per dispatch (ms)"),
    ("device_dispatch_ms", "histogram",
     "device dispatch wall time per batch/leg (ms)"),
)


class GatewayMetrics:
    """Cached handles into one registry for the shared schema — one
    attribute read per emission on the hot path, no name lookups."""

    def __init__(self, registry: MetricsRegistry):
        self.registry = registry
        for name, kind, help_ in METRIC_SCHEMA:
            if kind == "counter":
                m = registry.counter(name, help_)
            elif kind == "gauge":
                m = registry.gauge(name, help_)
            else:
                m = registry.histogram(name, help_)
            setattr(self, name, m)


def stats_projection(snap: dict, raw_elapsed: float) -> dict:
    """The legacy flat ``stats()`` dict, derived from a registry
    snapshot. Every tier — including the fleet-wide MERGE of per-host
    snapshots — reports through this one function, so keys and derived
    ratios cannot diverge across the five gateways again."""
    elapsed = max(raw_elapsed, 1e-9)

    def n(key):
        return snap.get(key, 0) or 0

    w = snap.get("wait_ms") or {}
    ce = snap.get("cost_est_error_ms") or {}
    completed = int(n("completed"))
    tokens_out = int(n("tokens_out"))
    slot_total = n("slot_steps_total")
    return {
        "queue_depth": int(n("queue_depth")),
        "inflight": int(n("inflight")),
        "submitted": int(n("submitted")),
        "completed": completed,
        "failed": int(n("failed")),
        "batches": int(n("batches")),
        "mixed_batches": int(n("mixed_batches")),
        "forwards": int(n("forwards")),
        "nfe_per_request": n("forwards") / max(completed, 1),
        "occupancy": n("real_rows") / max(n("padded_rows"), 1),
        "mean_wait_ms": w.get("sum", 0.0) / max(completed, 1),
        "max_wait_ms": w.get("max", 0.0),
        "wait_p50_ms": w.get("p50", 0.0),
        "wait_p95_ms": w.get("p95", 0.0),
        "wait_p99_ms": w.get("p99", 0.0),
        "throughput_rps": completed / elapsed,
        "jit_programs": int(n("jit_programs")),
        # continuous batching (all zero under the flush-only gateway)
        "trajectories": int(n("trajectories")),
        "legs": int(n("legs")),
        "joins": int(n("joins")),
        "join_rate": n("joins") / max(completed, 1),
        "slot_occupancy": (n("slot_steps_active") / slot_total
                           if slot_total else 0.0),
        # decode serving (zero under the flow gateways)
        "tokens_out": tokens_out,
        # a zero-elapsed snapshot (frozen fake clock, or stats() in the
        # same instant as construction) must read 0, not tokens/1e-9
        "tokens_per_s": (tokens_out / elapsed if raw_elapsed > 0 else 0.0),
        "cancelled": int(n("cancelled")),
        "prefill_calls": int(n("prefill_calls")),
        "prefill_tokens": int(n("prefill_tokens")),
        # fleet federation (zero outside a FleetGateway)
        "stolen_in": int(n("stolen_in")),
        "stolen_out": int(n("stolen_out")),
        # SLO scheduling (zero without deadlines). hit rate is measured
        # over OFFERED deadline requests: on-time completions / (on-time
        # + late-or-shed + fast-rejected) — a gateway cannot improve it
        # by rejecting everything
        "rejected": int(n("rejected")),
        "preemptions": int(n("preemptions")),
        "deadline_misses": int(n("deadline_misses")),
        "goodput": int(n("goodput")),
        "deadline_hit_rate": (
            n("goodput")
            / max(n("goodput") + n("deadline_misses") + n("rejected"), 1)),
        # admission cost-model calibration (zero without deadline traffic):
        # how far the wait estimate stamped at submit landed from the
        # actual settle time, over every deadline request that settled
        "cost_est_samples": int(ce.get("count", 0)),
        "cost_est_error_mean_ms": (ce.get("sum", 0.0)
                                   / max(ce.get("count", 0), 1)),
        "cost_est_error_p95_ms": ce.get("p95", 0.0),
    }


class GatewayBase:
    """Shared request-queue front-end: thread-safe intake, the serve-thread
    lifecycle, drain, in-flight accounting, and aggregate ``stats()`` — the
    machinery common to the flow gateways (``Gateway``/``ContinuousGateway``)
    and the decode gateway (``repro.serving.decode.DecodeGateway``).

    Subclasses implement ``submit`` (build an entry, hand it to
    ``_enqueue``) and ``pump`` (plan one tick: pull planned entries off the
    queue with ``_take``, and ``_settle`` them once their futures resolve
    or fail).
    """

    #: request dataclass ``submit_stream`` builds from kwargs (set by each
    #: subclass: ``DecodeRequest`` for the decode gateway)
    _request_type: type = None

    def __init__(self, clock: Callable[[], float] = time.monotonic,
                 metrics: Optional[MetricsRegistry] = None,
                 recorder=None, slo: Optional[SLOConfig] = None):
        self.clock = clock
        self.slo = slo
        self.queue = RequestQueue()
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._m = GatewayMetrics(self.metrics)
        self.recorder = recorder if recorder is not None else NULL_RECORDER
        self._host = ""    # fleet host label stamped into trace events
        self._started = clock()
        self._uid = itertools.count()
        self._plan_lock = threading.Lock()
        self._intake_lock = threading.Lock()   # closed-check + push atomic
        # the registry RLock IS the stats lock: a block of handle updates
        # is one atomic multi-metric transaction, and snapshot() sees a
        # consistent cut (drain + serve thread both execute; '+=' on the
        # handles is not atomic without it)
        self._stats_lock = self.metrics.lock
        self._inflight = 0   # entries off the queue, futures still unresolved
        self._programs: set = set()   # distinct jit programs dispatched
        # lazy gauges: queue depth / in-flight already live on the
        # gateway; the registry reads them at snapshot time instead of
        # double-booking every transition
        self._m.queue_depth.set_fn(self.queue.depth)
        self._m.inflight.set_fn(lambda: self._inflight)
        self._closed = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @property
    def stats_raw(self) -> GatewayStats:
        """Compatibility view: the legacy counter dataclass reconstructed
        from the registry under its lock (one consistent cut)."""
        m = self._m
        with self._stats_lock:
            return GatewayStats(
                submitted=m.submitted.value,
                completed=m.completed.value,
                failed=m.failed.value,
                batches=m.batches.value,
                mixed_batches=m.mixed_batches.value,
                forwards=m.forwards.value,
                real_rows=m.real_rows.value,
                padded_rows=m.padded_rows.value,
                sum_wait_ms=m.wait_ms.sum,
                max_wait_ms=m.wait_ms.max,
                started=self._started,
                trajectories=m.trajectories.value,
                legs=m.legs.value,
                joins=m.joins.value,
                join_forwards=m.join_forwards.value,
                slot_steps_active=m.slot_steps_active.value,
                slot_steps_total=m.slot_steps_total.value,
                tokens_out=m.tokens_out.value,
                cancelled=m.cancelled.value,
                prefill_calls=m.prefill_calls.value,
                prefill_tokens=m.prefill_tokens.value,
                stolen_in=m.stolen_in.value,
                stolen_out=m.stolen_out.value,
                rejected=m.rejected.value,
                preemptions=m.preemptions.value,
                deadline_misses=m.deadline_misses.value,
                goodput=m.goodput.value,
            )

    def _note_program(self, program: str) -> None:
        """Per-dispatch program accounting (caller holds ``_stats_lock``):
        one labelled ``dispatches`` tick, and the ``jit_programs`` gauge
        (named as in the reference's schema) tracks the distinct dispatch
        shapes seen."""
        if program not in self._programs:
            self._programs.add(program)
            self._m.jit_programs.set(len(self._programs))
        self.metrics.counter("dispatches",
                             "dispatches per compiled jit program",
                             labels={"program": program}).inc()

    # -- intake ---------------------------------------------------------------

    def _enqueue(self, entry) -> Future:
        """Push one entry; the closed check and the push are one atomic step
        wrt ``drain()`` — once drain flips ``_closed`` (under this lock), no
        entry can slip in after its final flush and strand an unresolved
        future. The submitted counter moves under ``_stats_lock`` like every
        other counter, and BEFORE the push, so no ``stats()`` snapshot can
        show ``completed > submitted``."""
        with self._intake_lock:
            if self._closed:
                raise RuntimeError("gateway is draining; no new requests")
            self._m.submitted.inc()
            # the Future carries the uid so callers holding only the
            # future (FleetGateway.submit, trace consumers) can stamp /
            # look up events without the private entry
            entry.future.uid = entry.uid
            sink = getattr(entry, "sink", None)
            if sink is not None:
                # submit_stream reads the sink back off the future (the
                # entry is private; the future crosses the fleet tier)
                entry.future.stream_sink = sink
            self.queue.push(entry)
        rec = self.recorder
        if rec:
            rec.event(entry.uid, "submit", entry.t_submit, host=self._host)
        return entry.future

    # -- in-flight accounting -------------------------------------------------

    def _take(self, entries: Sequence) -> None:
        """Remove planned entries from the queue and mark them IN FLIGHT.
        ``drain()`` waits on this count, not just queue depth: entries a
        concurrent serve-thread pump has removed and is still executing are
        invisible to the queue, and the old depth-only loop could return
        with their futures unresolved.

        The increment happens BEFORE the queue removal (and ``_drained``
        reads depth before in-flight): an entry is therefore visible to at
        least one of the two checks at every instant of the hand-off —
        counting it twice momentarily is safe, missing it is the race."""
        with self._stats_lock:
            self._inflight += len(entries)
        self.queue.remove({e.uid for e in entries})

    def _settle(self, n: int) -> None:
        """Mark ``n`` taken entries resolved (result or exception set)."""
        with self._stats_lock:
            self._inflight -= n

    def _fail_entries(self, entries: Sequence, exc: BaseException,
                      count_all: bool = False) -> None:
        """Surface ``exc`` into every still-unresolved future. A future the
        client already cancelled rejects ``set_exception``; that must not
        keep the failure from reaching its batch-mates."""
        failed = 0
        rec = self.recorder
        now = self.clock()
        for e in entries:
            try:
                e.future.set_exception(exc)
                failed += 1
            except Exception:       # cancelled/raced future: nothing to do
                failed += int(count_all)
            sink = getattr(e, "sink", None)
            if sink is not None:
                sink.error(exc)     # unblock a consumer iterating the stream
            if rec:
                rec.event(e.uid, "settle", now, host=self._host,
                          status="failed")
        if failed:
            self._m.failed.inc(failed)

    # -- SLO scheduling (repro.serving.slo) -----------------------------------

    def _dispatch_cost_ms(self) -> float:
        """Observed mean cost of one dispatch (assembly + device), read
        from the registry's own histograms — the admission cost model
        calibrates itself from live traffic. Before the first dispatch it
        falls back to ``slo.default_cost_ms`` (0 = optimistic accept)."""
        with self._stats_lock:
            dispatch = hist_mean(self._m.device_dispatch_ms)
            assembly = hist_mean(self._m.host_assembly_ms)
        if dispatch is None:
            return self.slo.default_cost_ms if self.slo else 0.0
        return dispatch + (assembly or 0.0)

    def _estimate_wait_ms(self, entry) -> float:
        """Modeled time until ``entry`` would settle, given the current
        queue. Subclasses refine with their batching shape; the base
        estimate is one dispatch per queued entry ahead plus our own."""
        return self._dispatch_cost_ms() * (self.queue.depth() + 1)

    def _check_admission(self, entry) -> None:
        """Fast reject: raise ``AdmissionRejected`` when the modeled
        service time cannot meet the entry's deadline. Called by submit
        BEFORE ``_enqueue`` — a rejected request is never counted as
        submitted and its caller gets the exception, not a future."""
        slo = self.slo
        if slo is None or not slo.admission or entry.deadline is None:
            return
        est = self._estimate_wait_ms(entry)
        # stamp the estimate for calibration: at settle, |estimate -
        # actual| lands in cost_est_error_ms (a rejected entry never
        # settles, so the stamp is inert on the reject path)
        entry.est_wait_ms = est
        budget = (entry.deadline - self.clock()) * 1e3 - slo.slack_ms
        if est > budget:
            depth = self.queue.depth()
            with self._stats_lock:
                self._m.rejected.inc()
            rec = self.recorder
            if rec:
                rec.event(entry.uid, "reject", self.clock(), host=self._host,
                          estimated_ms=est, queue_depth=depth)
            raise AdmissionRejected(
                f"deadline infeasible: modeled service {est:.1f}ms exceeds "
                f"the remaining budget {budget:.1f}ms "
                f"(queue_depth={depth})",
                estimated_ms=est, deadline_ms=budget, queue_depth=depth)

    def _shed_expired(self) -> None:
        """Fail queued entries whose deadline already passed (caller holds
        ``_plan_lock``). Their forwards go to requests that can still
        win; each shed entry counts under ``failed`` AND
        ``deadline_misses``."""
        slo = self.slo
        if slo is None or not slo.shedding:
            return
        now = self.clock()
        expired = [e for e in self.queue.snapshot()
                   if e.deadline is not None
                   and (now - e.deadline) * 1e3 > -slo.slack_ms]
        if not expired:
            return
        self._take(expired)
        with self._stats_lock:
            self._m.deadline_misses.inc(len(expired))
        self._fail_entries(
            expired,
            DeadlineExceeded(f"deadline passed while queued "
                             f"({len(expired)} shed at t={now:.3f})"),
            count_all=True)
        self._settle(len(expired))

    def _note_deadline(self, entry, settle_t: float) -> None:
        """Goodput accounting at settle (caller holds ``_stats_lock``):
        a deadline request completing on time ticks ``goodput``, late
        ticks ``deadline_misses``. No-deadline requests tick neither."""
        if entry.deadline is None:
            return
        if settle_t <= entry.deadline:
            self._m.goodput.inc()
        else:
            self._m.deadline_misses.inc()
        est = getattr(entry, "est_wait_ms", None)
        if est is not None:
            actual = (settle_t - entry.t_submit) * 1e3
            self._m.cost_est_error_ms.observe(abs(actual - est))

    # -- streaming (repro.serving.stream) -------------------------------------

    def submit_stream(self, request=None, **kw) -> ResponseStream:
        """Submit with streaming: returns a ``ResponseStream`` yielding
        per-exit-boundary partials (flow) or per-token chunks (decode),
        terminated by the same response the future resolves with."""
        if request is None:
            request = self._request_type(**kw)
        request.stream = True
        future = self.submit(request)
        return ResponseStream(future, future.stream_sink)

    # -- fleet federation hooks (repro.serving.fleet) ------------------------

    def federate(self, uid_counter, base_seed: Optional[int] = None, *,
                 recorder=None, host: Optional[str] = None) -> None:
        """Adopt a fleet-shared uid namespace (and base seed).

        Entries migrated between shard queues are identified by uid alone
        (``RequestQueue.remove``/``_take``); per-host counters would
        collide, so every host in a fleet draws from ONE counter. Sharing
        the base seed keeps sampled requests bit-identical to a single
        gateway: the folded seed depends on the fleet-wide submission
        index, which the shared counter makes exactly the index a lone
        gateway would have used. Call before any traffic is submitted.

        ``recorder``/``host`` wire fleet-wide tracing: every host stamps
        events into the fleet's ONE recorder, labelled with its host
        name, so a stolen request's hops interleave in one ring."""
        self._uid = uid_counter
        if base_seed is not None and hasattr(self, "_base_seed"):
            self._base_seed = base_seed
        if recorder is not None:
            self.recorder = recorder
        if host is not None:
            self._host = host

    def load(self) -> HostLoad:
        """Load snapshot for fleet routing/stealing decisions."""
        with self._stats_lock:
            inflight = self._inflight
        pending = self.queue.snapshot()
        return HostLoad(queue_depth=len(pending), inflight=inflight,
                        urgent=sum(1 for e in pending if is_urgent(e)))

    def steal(self, max_n: Optional[int] = None) -> list:
        """Atomically pop up to ``max_n`` QUEUED entries (most urgent
        first — for plain entries the urgency key degenerates to the old
        oldest-first order; ``None`` = all). Runs under ``_plan_lock``,
        the same lock every pump plans under, so a stolen entry was never
        planned into a batch or trajectory — in-flight work is
        structurally unstealable. The entries' futures stay live; the
        thief resolves them."""
        with self._plan_lock:
            pending = sorted(self.queue.snapshot(), key=urgency_key)
            taken = pending if max_n is None else pending[:max_n]
            self.queue.remove({e.uid for e in taken})
        if taken:
            self._m.stolen_out.inc(len(taken))
            rec = self.recorder
            if rec:
                now = self.clock()
                for e in taken:
                    rec.event(e.uid, "steal", now, host=self._host)
        return taken

    def inject(self, entries: Sequence) -> None:
        """Accept entries stolen from another shard into this queue. The
        closed check mirrors ``_enqueue`` (an entry injected after drain's
        final flush would strand its future) but ``submitted`` does NOT
        move — the home shard already counted the request; fleet totals
        stay one-count-per-request."""
        with self._intake_lock:
            if self._closed:
                raise RuntimeError(
                    "gateway is draining; cannot accept migrated entries")
            self._m.stolen_in.inc(len(entries))
            for e in entries:
                self.queue.push(e)
        rec = self.recorder
        if rec:
            now = self.clock()
            for e in entries:
                rec.event(e.uid, "inject", now, host=self._host)

    # -- scheduling -----------------------------------------------------------

    def pump(self, force: bool = False) -> int:
        raise NotImplementedError

    # -- lifecycle ------------------------------------------------------------

    def serve_forever(self, poll_s: float = 0.001) -> None:
        """Pump until ``stop``; sleeps ``poll_s`` when there is no work."""
        while not self._stop.is_set():
            if self.pump() == 0:
                time.sleep(poll_s)

    def start(self, poll_s: float = 0.001) -> threading.Thread:
        if self._thread is not None and self._thread.is_alive():
            return self._thread
        self._stop.clear()
        self._thread = threading.Thread(
            target=self.serve_forever, kwargs={"poll_s": poll_s},
            name="gateway-serve", daemon=True)
        self._thread.start()
        return self._thread

    def _drained(self) -> bool:
        # depth FIRST, in-flight second — the mirror of _take's ordering.
        # If depth reads 0 because a concurrent _take just removed the
        # entry, its in-flight increment already happened, so the second
        # read catches it (unless it also settled, i.e. resolved — drained).
        if self.queue.depth():
            return False
        with self._stats_lock:
            return self._inflight == 0

    def drain(self, timeout: Optional[float] = None) -> None:
        """Graceful drain: refuse new requests, then pump until every
        accepted request has RESOLVED — queue empty AND nothing in flight
        (a batch a concurrent serve-thread pump is still executing counts;
        spinning on queue depth alone returned early on exactly that).

        ``timeout`` (wall seconds, measured on ``time.monotonic`` — the
        gateway clock may be fake and frozen) bounds the wait: a wedged
        engine raises ``DrainTimeout`` carrying the stats snapshot instead
        of hanging forever — fleet host-leave needs the bound. The gateway
        STAYS closed after the raise; call ``drain`` again to keep waiting,
        or inspect ``exc.stats`` to see what is stuck."""
        with self._intake_lock:
            self._closed = True        # no submit can pass the check now
        deadline = (None if timeout is None
                    else time.monotonic() + max(timeout, 0.0))
        while not self._drained():
            if deadline is not None and time.monotonic() >= deadline:
                registry = self.metrics.snapshot()
                snap = stats_projection(registry,
                                        self.clock() - self._started)
                rec = self.recorder
                raise DrainTimeout(
                    f"drain timed out after {timeout:g}s: "
                    f"queue_depth={snap['queue_depth']} "
                    f"inflight={snap['inflight']} "
                    f"completed={snap['completed']}/{snap['submitted']}",
                    snap, snapshot=registry,
                    spans=rec.open_spans() if rec else {})
            if self.pump(force=True) == 0:
                time.sleep(5e-4)       # a concurrent pump holds the work

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    def shutdown(self, timeout: Optional[float] = None) -> None:
        self.drain(timeout=timeout)
        self.stop()

    # -- metrics --------------------------------------------------------------

    def stats(self) -> dict[str, Any]:
        """Aggregate serving metrics as one flat dict: the compatibility
        projection of a registry snapshot (the snapshot is one consistent
        cut under the registry lock, so derived ratios are internally
        consistent — completed never exceeds submitted, the wait
        histogram count equals completed)."""
        return stats_projection(self.metrics.snapshot(),
                                self.clock() - self._started)

    def metrics_snapshot(self) -> dict:
        """Raw registry snapshot — the export surface (Prometheus/JSON).
        ``FleetGateway`` overrides this with the merge of its hosts'
        snapshots; everything below it reports its own registry."""
        return self.metrics.snapshot()
