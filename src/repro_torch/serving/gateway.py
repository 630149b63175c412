"""Serving gateway: async request queue and budget-coalescing batcher for
the flow samplers, and the gateway base every serving tier shares.

Port of ``repro.serving.gateway``. The distilled solver makes each request
cost exactly m backbone forwards; this module makes that speed survive
concurrency. Callers ``submit`` single-sample ``Request``s and get
``concurrent.futures.Future``s; the gateway coalesces pending requests into
padded fixed-size batches and runs them on a ``FlowSampler`` /
``AnytimeFlowSampler`` (or anything speaking the budget protocol:
``budgets``, ``resolve_budget``, ``sample_from``, and optionally
``sample_all_from``).

Batching contract
-----------------
* Requests are grouped by (resolved NFE budget, sample shape). A group
  reaching ``max_batch`` flushes immediately; partial groups flush once the
  oldest pending request has waited ``max_wait_ms`` (a flush tick drains all
  partial groups, so one aged request never strands its neighbours).
* Batches are padded to a fixed BUCKET size (powers of two up to
  ``max_batch``, plus ``max_batch`` itself), so each (budget, bucket) pair
  is one dispatch shape (``b{budget}/k{bucket}`` in the ``dispatches``
  counter; the reference compiles one jit program each, the port's samplers
  run eagerly). Pad rows are zeros; rows are independent through the
  backbone, so a served sample equals ``sampler.sample_from`` on the same
  assembled batch, to the bit.
* A per-budget batch at budget m costs exactly m backbone forwards,
  regardless of how many requests were coalesced into it.

Mixed-budget policy (``mixed_budget_policy``): when a flush tick leaves
partial groups at several budgets, per-budget dispatch costs
``sum(distinct budgets)`` forwards, while the anytime shared trajectory
(``sample_all_from``) serves every budget from ONE dispatch at
``max(sampler.budgets)``. "never" keeps per-budget batches, "auto" merges
iff that is strictly cheaper, "always" merges any multi-budget flush. Each
response's metadata records ``mixed`` and the requested/served budget pair.

Noise and transfers: a request without ``x0`` draws its noise at the native
shape on a CPU ``torch.Generator`` seeded with ``Request.seed``, or else
``engine.fold_in(base seed, uid)`` (the reference folds a PRNG key), so the
card and the CPU draw the same x0 and a result depends neither on the batch
nor on routing. Entries hold host numpy; each dispatch copies its assembled
x0 and tokens to the sampler's device once and its results back once,
inside the timed dispatch window (``device_dispatch_ms`` then covers the
card's work, not only the launches). ``Response.latents`` is a host numpy
row, as in the reference. One dispatch runs at a time (``EXEC_LOCK``, one
for the process, so a fleet's hosts take turns too):
where the reference lets a draining thread dispatch beside the serve
thread, two torch threads would interleave their launches on one stream,
each window timing the other's work too. On the card the sampler replays
one CUDA graph a dispatch key (``serving.programs``); a key's first
dispatch captures it inside that lock, so no other thread launches work
during a capture, and ``stats()`` reports the captures and replays.

Continuous batching, preemption and shape tiers: ``serving.continuous``
and ``serving.tiers``. Backbone placement on a serving mesh (``mesh=``):
``serving.sharded``. Fleet federation: ``serving.fleet``, through the hooks
``GatewayBase`` carries (``load``/``steal``/``inject``/``federate``).

``GatewayBase`` holds everything sampler-agnostic (intake, serve thread,
drain with in-flight accounting, SLO admission and shedding, streaming, the
locked stats snapshot over ONE shared metric schema, ``METRIC_SCHEMA``) —
it also fronts the decode engine via ``serving.decode.DecodeGateway``.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.observability import NULL_RECORDER, MetricsRegistry, profile_span
from repro_torch.serving.engine import fold_in
from repro_torch.serving.programs import ProgramCache
from repro_torch.serving.sharded import scope as mesh_scope
from repro_torch.serving.slo import (
    AdmissionRejected,
    DeadlineExceeded,
    SLOConfig,
    hist_mean,
    is_urgent,
    urgency_key,
)
from repro_torch.serving.stream import ResponseStream, StreamSink
from repro_torch.serving.tiers import ShapeLadder, crop_row, pad_rows

POLICIES = ("never", "auto", "always")

# One dispatch runs in the process at a time. The reference lets the serve
# thread and a draining thread dispatch at once (jax is thread-safe); in
# torch two threads would interleave on one stream, so each dispatch window
# would also time the other's work, forward-mode AD (the schedulers' time
# derivatives) keeps levels that two threads must not share, and a CUDA
# graph capture must see no other thread's launches. The lock is the
# process's, not a gateway's: a fleet's hosts dispatch from threads of their
# own, and every gateway (flush, continuous, decode) takes it.
EXEC_LOCK = threading.RLock()


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
class Request:
    """One user's sample request: conditioning tokens (S,), an NFE budget
    (None = the sampler's top budget), and either explicit noise ``x0``
    (bit-reproducibility) or a ``seed`` for the noise draw (the gateway
    folds the request's uid into its base seed when both are None). Tensors
    or numpy arrays; the gateway keeps host numpy copies."""

    tokens: Optional[Any] = None
    budget: Optional[int] = None
    x0: Optional[Any] = None
    seed: Optional[int] = None
    # opt-in: resolve the Response with its recorded lifecycle trace
    # attached (requires the gateway to have a TraceRecorder)
    trace: bool = False
    # SLO (serving.slo): latency budget relative to submit (None =
    # best-effort) and scheduling priority (higher = more urgent; plain
    # requests at 0 keep exact FIFO order)
    deadline_ms: Optional[float] = None
    priority: int = 0
    # streaming (serving.stream): emit per-exit-boundary partials; set by
    # submit_stream, which returns the ResponseStream
    stream: bool = False


@dataclasses.dataclass
class Response:
    """One sample plus its serving metadata.

    ``latents`` is the sample's row as host numpy (the gateway does one
    device-to-host copy per BATCH and scatters rows in numpy — per-row
    device slicing costs an op per request and erases the batching win at
    small budgets).

    ``meta`` records: requested_budget, served_budget (budget drift is data,
    not just a warning), nfe_batch (backbone forwards the carrying batch
    spent), batch_real / batch_padded (occupancy), mixed (shared-trajectory
    dispatch), wait_ms (queue time).

    ``trace`` is the request's recorded lifecycle (list of event dicts)
    when ``Request.trace`` was set and the gateway has a recorder.
    """

    latents: np.ndarray
    meta: dict
    trace: Optional[list] = None


@dataclasses.dataclass
class _Entry:
    uid: int
    tokens: Optional[np.ndarray]
    x0: np.ndarray
    requested: int
    served: int
    shape_key: tuple
    t_submit: float
    future: Future
    # continuous batching (serving.continuous): when this entry was
    # admitted into a trajectory (wait ends here, not at exit) and at which
    # exit boundary it joined (0 = opened the trajectory)
    t_admit: Optional[float] = None
    join_step: int = 0
    trace: bool = False   # attach the recorded lifecycle to the Response
    # SLO scheduling: ABSOLUTE deadline on the gateway clock (None =
    # best-effort) and priority (higher = more urgent)
    deadline: Optional[float] = None
    priority: int = 0
    # streaming sink (serving.stream.StreamSink), or None
    sink: Optional[Any] = None
    # preemption (continuous tier): host snapshot of this entry's carry
    # column, taken when its slot was evicted at an exit boundary
    # (serving.slo.PausedCarry); resume restores it bit-identically
    paused: Optional[Any] = None
    # shape tiering (serving.tiers): the x0 shape BEFORE tier padding (None
    # = untiered); ``shape_key``/``x0``/``tokens`` hold the padded tier
    # forms, and every settle path crops back to this
    native_shape: Optional[tuple] = None
    # SLO calibration: the admission cost model's wait estimate stamped
    # at submit; |estimate - actual| lands in ``cost_est_error_ms``
    est_wait_ms: Optional[float] = None


def to_host(x) -> np.ndarray:
    """A host numpy array of ``x`` (a tensor on any device, or array-like).
    A CPU tensor is copied, so the array never aliases a tensor that later
    work may write in place; a card tensor's copy waits for the card."""
    if isinstance(x, torch.Tensor):
        if type(x) is not torch.Tensor and hasattr(x, "full_tensor"):
            x = x.full_tensor()          # a DTensor of the mesh path, gathered
        return x.detach().to("cpu", copy=True).numpy()
    return np.asarray(x)


def request_noise(length: int, latent_dim: int, seed: int) -> np.ndarray:
    """The noise of a request without ``x0``: (length, latent_dim) f32 from
    a CPU generator seeded with ``seed`` — the same draw on every device,
    batch and route."""
    gen = torch.Generator().manual_seed(seed)
    return torch.randn((length, latent_dim), generator=gen, dtype=torch.float32).numpy()


def assemble_rows(entries: Sequence["_Entry"], bucket: int):
    """Host-side padded-batch assembly, shared by flush execution,
    trajectory starts, and join-prefix dispatches: stack each entry's x0
    (and tokens) and zero-pad to ``bucket`` rows — ONE device transfer per
    dispatch, and the single definition of the pad contract (zero rows,
    independent through the backbone, so padding never perturbs a real
    sample). Returns host numpy arrays ``(x0, tokens-or-None)``."""
    pad = bucket - len(entries)
    x0 = np.stack([np.asarray(e.x0) for e in entries])
    if pad:
        x0 = np.concatenate(
            [x0, np.zeros((pad,) + x0.shape[1:], x0.dtype)])
    tokens = None
    if entries[0].tokens is not None:
        tokens = np.stack([np.asarray(e.tokens) for e in entries]
                          + [np.zeros_like(np.asarray(entries[0].tokens))]
                          * pad)
    return x0, tokens


def to_device(x0_np: np.ndarray, tokens_np: Optional[np.ndarray], device):
    """One host-to-device copy of an assembled batch: ``(cond, x0)``, with
    ``cond`` None when the batch has no tokens. ``device`` None keeps them
    on the CPU (the toy samplers)."""
    x0 = torch.from_numpy(x0_np)
    tokens = None if tokens_np is None else torch.from_numpy(tokens_np)
    if device is not None:
        x0 = x0.to(device)
        tokens = None if tokens is None else tokens.to(device)
    return (None if tokens is None else {"tokens": tokens}), x0


@dataclasses.dataclass
class Batch:
    """A planned dispatch: FIFO entries, the served budget (None when the
    batch rides the shared anytime trajectory), and the padded bucket."""

    entries: list
    budget: Optional[int]
    bucket: int
    mixed: bool = False


class BatchScheduler:
    """Deterministic batch planning (pure function of pending + now).

    ``plan`` never touches wall-clock or device state, so tests drive it
    with a fake clock and assert the exact batch layout.
    """

    def __init__(self, max_batch: int = 8, max_wait_ms: float = 10.0,
                 policy: str = "auto", can_mix: bool = False,
                 top_budget: Optional[int] = None, slo_aware: bool = False):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if policy not in POLICIES:
            raise ValueError(f"mixed_budget_policy {policy!r} not in {POLICIES}")
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1e3
        self.policy = policy
        self.can_mix = can_mix
        self.top_budget = top_budget
        # SLO mode: order entries by urgency_key instead of FIFO, and add
        # deadline pressure to the flush trigger. ``lead_ms`` is the
        # gateway's current one-dispatch cost estimate (refreshed each
        # pump from the registry histograms): a partial group flushes
        # early when waiting one more tick would miss a member's deadline
        self.slo_aware = slo_aware
        self.lead_ms = 0.0
        self._buckets = self._bucket_sizes(max_batch)

    @staticmethod
    def _bucket_sizes(max_batch: int) -> tuple[int, ...]:
        sizes = {max_batch}
        b = 1
        while b < max_batch:
            sizes.add(b)
            b *= 2
        return tuple(sorted(sizes))

    def bucket(self, count: int) -> int:
        """Smallest padded size holding ``count`` — one dispatch shape per
        (budget, bucket), not one per observed batch size."""
        for b in self._buckets:
            if b >= count:
                return b
        raise ValueError(f"count {count} exceeds max_batch {self.max_batch}")

    def _use_mixed(self, budgets: Sequence[int], total: int) -> bool:
        """Cost model in backbone forwards per flush: per-budget dispatch
        costs sum(distinct budgets) — leftover groups are below max_batch,
        one dispatch each — while merging dispatches ceil(total / max_batch)
        chunks of the shared trajectory, each running to the sampler's TOP
        budget (``sample_all``). Merge only when that is strictly cheaper."""
        if not self.can_mix or len(budgets) < 2 or self.policy == "never":
            return False
        if self.policy == "always":
            return True
        if self.top_budget is None:
            return False
        chunks = -(-total // self.max_batch)
        return chunks * self.top_budget < sum(budgets)

    def plan(self, pending: Sequence[_Entry], now: float,
             force: bool = False) -> list[Batch]:
        """The batches ready to dispatch; unbatched entries stay pending
        (the caller removes exactly the batched entries from its queue)."""
        batches: list[Batch] = []
        groups: dict[tuple, list[_Entry]] = {}
        if self.slo_aware:
            pending = sorted(pending, key=urgency_key)
        for e in pending:
            groups.setdefault((e.shape_key, e.served), []).append(e)

        leftovers: dict[tuple, list[_Entry]] = {}
        for (shape, served), es in groups.items():
            while len(es) >= self.max_batch:
                head, es = es[:self.max_batch], es[self.max_batch:]
                batches.append(Batch(head, served, self.bucket(len(head))))
            if es:
                leftovers[(shape, served)] = es

        aged = any(now - e.t_submit >= self.max_wait_s
                   for es in leftovers.values() for e in es)
        if self.slo_aware and not aged:
            # deadline pressure: flush partials when waiting one more
            # dispatch would push a member past its deadline
            lead_s = self.lead_ms / 1e3
            aged = any(e.deadline is not None and now + lead_s >= e.deadline
                       for es in leftovers.values() for e in es)
        if not (force or aged):
            return batches

        by_shape: dict[tuple, dict[int, list[_Entry]]] = {}
        for (shape, served), es in leftovers.items():
            by_shape.setdefault(shape, {})[served] = es
        for shape in sorted(by_shape, key=repr):
            per_budget = by_shape[shape]
            total = sum(len(es) for es in per_budget.values())
            if self._use_mixed(sorted(per_budget), total):
                merged = sorted((e for es in per_budget.values() for e in es),
                                key=lambda e: e.uid)
                for i in range(0, len(merged), self.max_batch):
                    chunk = merged[i:i + self.max_batch]
                    served_set = {e.served for e in chunk}
                    if len(served_set) > 1:
                        batches.append(Batch(chunk, None,
                                             self.bucket(len(chunk)),
                                             mixed=True))
                    else:
                        batches.append(Batch(chunk, chunk[0].served,
                                             self.bucket(len(chunk))))
            else:
                for served in sorted(per_budget):
                    es = per_budget[served]
                    batches.append(Batch(es, served, self.bucket(len(es))))
        if self.slo_aware and len(batches) > 1:
            # most urgent batch dispatches first (batches run serially
            # within one pump; an urgent batch behind a long one misses)
            batches.sort(key=lambda b: min(urgency_key(e)
                                           for e in b.entries))
        return batches


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
    ("jit_programs", "gauge", "programs the engine has captured as CUDA "
                              "graphs (a climb in steady state = recapturing)"),
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
        self.mesh = None    # the serving mesh (the gateways that take mesh=)
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

    def _program_cache(self):
        """The ``serving.programs.ProgramCache`` of the engine behind this
        gateway (a flow sampler's or the decode engine's), or None (toys)."""
        engine = getattr(self, "sampler", None) or getattr(self, "engine", None)
        cache = getattr(engine, "programs", None)
        return cache if isinstance(cache, ProgramCache) else None

    def _note_program(self, program: str) -> None:
        """Per-dispatch program accounting (caller holds ``_stats_lock``):
        one labelled ``dispatches`` tick per dispatch shape (the flush
        gateway's ``b{budget}/k{bucket}`` batches, the continuous gateway's
        ``leg/{start}-{stop}`` legs and join prefixes, the decode gateway's
        steps and prefill widths), and the ``jit_programs`` gauge (named as in
        the reference's schema) reads the programs the engine's cache has
        captured: one a key, 0 where the engine runs eagerly (the CPU)."""
        cache = self._program_cache()
        self._m.jit_programs.set(0 if cache is None else len(cache))
        self.metrics.counter("dispatches",
                             "dispatches per compiled jit program",
                             labels={"program": program}).inc()

    def _note_tier(self, tier_shape: tuple, real: int, padded: int) -> None:
        """Per-tier occupancy accounting (caller holds ``_stats_lock``):
        labelled native/padded position-row counters per shape tier, and
        the labelled ``tier_occupancy`` gauge as their running ratio —
        1.0 means every padded position carried a native row; the gap is
        what tier padding (plus batch padding) costs this tier."""
        label = ShapeLadder.label(tier_shape)
        reg = self.metrics
        r = reg.counter("tier_real_rows",
                        "native position-rows dispatched, per shape tier",
                        labels={"tier": label})
        p = reg.counter("tier_padded_rows",
                        "padded position-rows dispatched, per shape tier",
                        labels={"tier": label})
        r.inc(real)
        p.inc(padded)
        reg.gauge(
            "tier_occupancy",
            "native/padded position-row share of dispatched work, per "
            "shape tier",
            labels={"tier": label}).set(r.value / max(p.value, 1))

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
        out = stats_projection(self.metrics.snapshot(), self.clock() - self._started)
        cache = self._program_cache()
        if cache is not None:
            cs = cache.stats()
            out.update(program_captures=cs["programs"], program_replays=cs["replays"],
                       program_capture_ms=cs["capture_ms"])
        return out

    def metrics_snapshot(self) -> dict:
        """Raw registry snapshot — the export surface (Prometheus/JSON).
        ``FleetGateway`` overrides this with the merge of its hosts'
        snapshots; everything below it reports its own registry."""
        return self.metrics.snapshot()


class Gateway(GatewayBase):
    """Multi-user front-end over one budget-routing sampler.

    ``submit(request) -> Future[Response]``; ``pump()`` plans and executes
    ready batches (the unit tests drive it with a fake clock); ``start()`` /
    ``serve_forever()`` run the pump loop on a thread, inside the sampler's
    CUDA device; ``drain()`` stops accepting and flushes everything;
    ``shutdown()`` = drain + stop.

    ``from_zoo`` acquires the solver artifact through a ``SolverZoo`` so a
    gateway boot is a cache hit/load, never an accidental re-distillation.
    ``seed`` is the base seed that noise of requests without ``x0`` or
    ``seed`` folds its uid into. ``mesh`` (a ``DeviceMesh`` with ("data",
    "model") axes, ``launch.mesh``) places the sampler's weights by the
    sharding rules (``serving.sharded.shard_sampler``) and splits each
    assembled batch over the data axes before dispatch (``tier_placer``
    under ``tiers``, else ``batch_placer``); the kernels run on each rank's
    local shard.
    """

    _request_type = Request     # submit_stream builds these

    def __init__(self, sampler, *, max_batch: int = 8,
                 max_wait_ms: float = 10.0,
                 mixed_budget_policy: str = "auto", strict_nfe: bool = False,
                 mesh=None, clock: Callable[[], float] = time.monotonic,
                 seed: int = 0,
                 metrics: Optional[MetricsRegistry] = None, recorder=None,
                 slo: Optional[SLOConfig] = None,
                 tiers: Optional[ShapeLadder] = None):
        super().__init__(clock=clock, metrics=metrics, recorder=recorder,
                         slo=slo)
        self.sampler = sampler
        self.mesh = mesh
        self._place = None
        if mesh is not None:
            from repro_torch.serving import sharded

            sharded.shard_sampler(sampler, mesh)
            self._place = (sharded.tier_placer(mesh, tiers) if tiers is not None
                           else sharded.batch_placer(mesh))
        # where the sampler's work runs (None: the toys' CPU tensors)
        dev = getattr(sampler, "device", None)
        self._device = None if dev is None else torch.device(dev)
        # shape-tier ladder (serving.tiers): when set, submit pads each
        # request's position axis to its tier rung, so shape_key — the
        # grouping key of every scheduler layer — IS the tier key and
        # near-shapes share flush buckets / trajectory slots. None keeps
        # the exact-shape behaviour
        self.tiers = tiers
        can_mix = (hasattr(sampler, "sample_all_from")
                   and len(sampler.budgets) > 1)
        self.scheduler = BatchScheduler(
            max_batch=max_batch, max_wait_ms=max_wait_ms,
            policy=mixed_budget_policy, can_mix=can_mix,
            top_budget=max(sampler.budgets), slo_aware=slo is not None)
        self.strict_nfe = strict_nfe
        self._base_seed = seed

    @classmethod
    def from_zoo(cls, zoo, spec, *, params: dict, cfg, sched, log=None,
                 **gateway_kw) -> "Gateway":
        """Boot a gateway from a zoo-resolved artifact (hit/load/distill).
        Takes no ``update_fn`` (the reference's takes one): the port's
        samplers always update through the ``ns_update`` kernel on the card
        and its plain version on the CPU."""
        from repro_torch.serving.engine import AnytimeFlowSampler, FlowSampler

        artifact = zoo.get(spec, log=log)
        kind = AnytimeFlowSampler if artifact.kind == "anytime" else FlowSampler
        sampler = kind.from_artifact(artifact, params=params, cfg=cfg,
                                     sched=sched)
        return cls(sampler, **gateway_kw)

    # -- intake -------------------------------------------------------------

    def submit(self, request: Optional[Request] = None, **kw) -> Future:
        """Enqueue one request; returns a Future resolving to ``Response``.

        The budget is resolved to a served one NOW (strict mode raises here,
        before the request ever queues); the (requested, served) pair rides
        in the response metadata either way.
        """
        if request is None:
            request = Request(**kw)
        requested = (request.budget if request.budget is not None
                     else self.sampler.budgets[-1])
        served = self.sampler.resolve_budget(requested,
                                             strict=self.strict_nfe)
        uid = next(self._uid)
        tokens = None if request.tokens is None else to_host(request.tokens)
        if request.x0 is not None:
            x0 = to_host(request.x0)
        else:
            if tokens is None:
                raise ValueError("request needs tokens and/or explicit x0")
            seed = (request.seed if request.seed is not None
                    else fold_in(self._base_seed, uid))
            x0 = request_noise(tokens.shape[0], self.sampler.cfg.latent_dim, seed)
        # tiering: noise is drawn at the NATIVE shape above, THEN the
        # position axis pads to the tier rung. shape_key is computed from
        # the padded forms, so every scheduler groups on the tier for free;
        # settle paths crop back to native_shape. Oversize raises here —
        # before the request is queued or counted (TierOversize).
        native_shape = None
        if self.tiers is not None:
            rung = self.tiers.rung_for(x0.shape)
            if rung is not None:
                native_shape = tuple(x0.shape)
                if rung != native_shape[0]:
                    x0 = pad_rows(x0, rung)
                if tokens is not None and tokens.shape[0] < rung:
                    tokens = pad_rows(tokens, rung)
        shape_key = (None if tokens is None
                     else tuple(tokens.shape), tuple(x0.shape))
        t_submit = self.clock()
        entry = _Entry(uid=uid, tokens=tokens, x0=x0,
                       requested=requested, served=served,
                       shape_key=shape_key, t_submit=t_submit,
                       native_shape=native_shape,
                       future=Future(), trace=request.trace,
                       deadline=(None if request.deadline_ms is None
                                 else t_submit + request.deadline_ms / 1e3),
                       priority=request.priority,
                       sink=StreamSink() if request.stream else None)
        self._check_admission(entry)
        return self._enqueue(entry)

    # -- scheduling / execution --------------------------------------------

    def serve_forever(self, poll_s: float = 0.001) -> None:
        """The pump loop, inside the sampler's CUDA device: the serve
        thread's current device would otherwise be the process default."""
        dev = self._device
        if dev is None or dev.type != "cuda":
            return super().serve_forever(poll_s)
        with torch.cuda.device(dev):
            return super().serve_forever(poll_s)

    def pump(self, force: bool = False) -> int:
        """Plan ready batches and execute them; returns how many ran."""
        with self._plan_lock:
            if self.slo is not None:
                self._shed_expired()
                self.scheduler.lead_ms = self._dispatch_cost_ms()
            batches = self.scheduler.plan(
                self.queue.snapshot(), self.clock(), force=force)
            # take exactly the batched entries — a submit landing after
            # the snapshot stays queued for the next pump, never dropped
            self._take([e for b in batches for e in b.entries])
        return self._run_batches(batches)

    def _estimate_wait_ms(self, entry) -> float:
        """Flush-gateway cost model: queued entries dispatch in batches of
        up to ``max_batch``, so the wait is (whole batches ahead of us,
        plus our own) times the observed per-dispatch cost."""
        batches_ahead = self.queue.depth() // self.scheduler.max_batch + 1
        return self._dispatch_cost_ms() * batches_ahead

    def _run_batches(self, batches: Sequence[Batch]) -> int:
        """Execute planned batches; an exception escaping one batch (e.g. a
        cancelled future rejecting its result mid-scatter) is surfaced into
        that batch's unresolved futures and the NEXT batch still runs —
        entries were already removed from the queue, so anything less
        strands their futures forever. Batches run under ``EXEC_LOCK``."""
        for batch in batches:
            try:
                with EXEC_LOCK, mesh_scope(self.mesh):
                    self._execute(batch)
            except BaseException as exc:  # noqa: BLE001 — must not strand
                self._fail_entries(batch.entries, exc)
            finally:
                self._settle(len(batch.entries))
        return len(batches)

    def _execute(self, batch: Batch) -> None:
        es = batch.entries
        dispatched = self.clock()   # wait_ms is QUEUE time, ending here —
        #                             not device time
        program = (f"b{'mix' if batch.mixed else batch.budget}"
                   f"/k{batch.bucket}")
        try:
            # assemble on host: ONE device transfer per batch, not one op
            # per request. Timing runs on the GATEWAY clock (production:
            # time.monotonic) so fake-clock benches feed the SLO cost
            # model simulated, deterministic dispatch times. The results'
            # copy to the host waits for the card inside t1..t2, so the
            # dispatch time covers the card's work, not only its launches
            t0 = self.clock()
            x0_np, t_np = assemble_rows(es, batch.bucket)
            cond, x0 = to_device(x0_np, t_np, self._device)
            if self._place is not None:
                cond, x0 = self._place(cond, x0)
            t1 = self.clock()
            with profile_span(f"gateway.dispatch.{program}"):
                if batch.mixed:
                    outs = self.sampler.sample_all_from(cond, x0)
                    nfe = max(self.sampler.budgets)
                    host = {m: to_host(outs[m]) for m in {e.served for e in es}}
                    rows = [host[e.served][i] for i, e in enumerate(es)]
                else:
                    lat = to_host(
                        self.sampler.sample_from(cond, x0, batch.budget))
                    nfe = batch.budget
                    rows = [lat[i] for i in range(len(es))]
            t2 = self.clock()
        except Exception as exc:
            self._fail_entries(es, exc, count_all=True)
            return
        settle_t = self.clock()
        with self._stats_lock:
            m = self._m
            m.batches.inc()
            if batch.mixed:
                m.mixed_batches.inc()
            m.forwards.inc(nfe)
            m.real_rows.inc(len(es))
            m.padded_rows.inc(batch.bucket)
            m.host_assembly_ms.observe((t1 - t0) * 1e3)
            m.device_dispatch_ms.observe((t2 - t1) * 1e3)
            self._note_program(program)
            if es[0].native_shape is not None:
                tier = es[0].shape_key[1]
                self._note_tier(
                    tier, sum(e.native_shape[0] for e in es),
                    batch.bucket * tier[0])
            for e in es:
                m.wait_ms.observe((dispatched - e.t_submit) * 1e3)
                m.completed.inc()
                self._note_deadline(e, settle_t)
        rec = self.recorder
        for e, row in zip(es, rows):
            row = crop_row(row, e.native_shape)
            wait_ms = (dispatched - e.t_submit) * 1e3
            if rec:
                rec.event(e.uid, "dispatch", dispatched, host=self._host,
                          program=program)
                rec.event(e.uid, "settle", dispatched, host=self._host,
                          status="completed")
            response = Response(latents=row, meta={
                "requested_budget": e.requested,
                "served_budget": e.served,
                "nfe_batch": nfe,
                "batch_real": len(es),
                "batch_padded": batch.bucket,
                "mixed": batch.mixed,
                "wait_ms": wait_ms,
            })
            if e.native_shape is not None:
                response.meta["tier_shape"] = e.shape_key[1]
                response.meta["native_shape"] = e.native_shape
            if e.trace and rec:
                response.trace = rec.trace(e.uid)
            try:
                e.future.set_result(response)
            except Exception:   # cancelled mid-batch: batch-mates still land
                pass
            if e.sink is not None:
                e.sink.final(response)
