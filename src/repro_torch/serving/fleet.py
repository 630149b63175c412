"""Fleet tier: multi-host gateway federation over a sharded request queue.

Port of ``repro.serving.fleet``. One gateway feeds one process; a BNS
solver artifact is tiny (<200 params), so replicating the SOLVER across
hosts is free and the scaling problem is request distribution. This module
federates N per-host gateways (each a ``Gateway`` / ``ContinuousGateway`` /
``DecodeGateway`` — anything built on ``GatewayBase``) behind one
``submit(request) -> Future``:

* **Sharded request queue.** Each host gateway's own ``RequestQueue`` is one
  SHARD, and a submit routes straight to its home shard. Entries carry
  fleet-unique uids (``GatewayBase.federate`` shares one counter) so they
  can migrate between shards without identity collisions.
* **Host-affinity routing.** ``FleetRouter`` assigns each request a home
  host by rendezvous (highest-random-weight) hashing of its AFFINITY KEY —
  (budget, sample shape) for flow (the TIER shape when the hosts run a
  ``ShapeLadder``), a max-tokens bucket for decode. Same-key requests
  congregate on one host, so its program cache (one CUDA graph a dispatch
  key on the card) stays hot and its batches coalesce denser. HRW over md5
  is a pure function of (key, live host set, seed): the same trace on the
  same fleet gives the same assignments in every run and in the reference.
* **Work stealing.** ``WorkStealer`` migrates QUEUED (never in-flight)
  entries from the deepest shards to idle hosts: ``GatewayBase.steal`` pops
  under the victim's plan lock, ``inject`` pushes into the thief. Migration
  moves host-side bookkeeping only — the entry's noise is already drawn —
  so a stolen request's sample is unchanged.
* **Graceful join/leave.** ``add_host`` registers a live host (HRW re-homes
  only the keys the new host wins); ``remove_host`` stops routing to the
  leaver, migrates its queue shard to the survivors, then drains its
  in-flight work with a BOUNDED ``drain(timeout=)`` — no future is dropped,
  and a wedged engine raises ``DrainTimeout`` instead of wedging the fleet.

Bit-identity invariant: rows are independent through the backbone and the
anytime trajectory is exact, so WHERE a request is served (which host,
which batch, before or after a steal) never changes its sample beyond what
the batch composition does to a lone gateway's; a request without ``x0``
draws its noise from ``fold_in(base_seed, uid)`` with the fleet-wide uid,
exactly the seed a lone gateway would fold at the same submission index.
Where the reference federates a base PRNG key, the port federates this
integer base seed.

``stats()`` aggregates the shared ``GatewayStats`` counters across hosts
and adds the fleet view: per-host queue depths, occupancy, routed counts,
steal totals.
"""
from __future__ import annotations

import dataclasses
import hashlib
import itertools
import threading
import time
from concurrent.futures import Future
from typing import Callable, Mapping, Optional, Sequence, Union

from repro_torch.observability import NULL_RECORDER, MetricsRegistry, merge_snapshots
from repro_torch.serving.gateway import GatewayBase, HostLoad, Request, stats_projection
from repro_torch.serving.stream import ResponseStream


def default_affinity(request, top_budget: Optional[int] = None, tiers=None) -> tuple:
    """The routing key: requests sharing it share a home host. Flow requests
    group by (budget, TIER shape) when the hosts run a ``ShapeLadder``, else
    by the exact (token shape, explicit-x0 shape); decode requests by a
    power-of-two max-tokens bucket."""
    if isinstance(request, Request):
        budget = request.budget if request.budget is not None else top_budget
        tok = None if request.tokens is None else tuple(request.tokens.shape)
        x0 = None if request.x0 is None else tuple(request.x0.shape)
        if tiers is not None:
            tok, x0 = tiers.request_key(tok, x0)
        return ("flow", budget, tok, x0)
    if hasattr(request, "prompt") and hasattr(request, "max_tokens"):
        return ("decode", _bucket(request.max_tokens))
    raise TypeError(f"no affinity key for request type {type(request)!r}; "
                    "pass affinity= to FleetGateway")


def entry_affinity(entry) -> tuple:
    """Routing key recomputed from a QUEUED entry (a leaving host's shard is
    re-homed after its request objects are gone). A tiered entry's
    ``shape_key`` already holds the padded tier shape."""
    if hasattr(entry, "shape_key"):                  # flow _Entry
        return ("flow", entry.requested, *entry.shape_key)
    if hasattr(entry, "prompt") and hasattr(entry, "max_tokens"):
        return ("decode", _bucket(entry.max_tokens))
    raise TypeError(f"no affinity key for entry type {type(entry)!r}")


def _bucket(max_tokens: int) -> int:
    bucket = 1
    while bucket < max_tokens:
        bucket *= 2
    return bucket


class FleetRouter:
    """Deterministic affinity routing via rendezvous (HRW) hashing.

    Each (key, host) pair gets the weight ``md5(seed|host|key)``; the key's
    home is the max-weight LIVE host. Removing a host re-homes only that
    host's keys; adding one re-homes only the keys it now wins. Keys are
    canonicalized via ``repr`` (tuples of ints/None/strings only), so a key
    routes to the same home here as in the reference."""

    def __init__(self, hosts: Sequence[str] = (), seed: int = 0):
        self.seed = seed
        self._hosts: list[str] = list(hosts)

    @property
    def hosts(self) -> tuple[str, ...]:
        return tuple(self._hosts)

    def add(self, name: str) -> None:
        if name in self._hosts:
            raise ValueError(f"host {name!r} already routed")
        self._hosts.append(name)

    def remove(self, name: str) -> None:
        self._hosts.remove(name)

    def weight(self, key: tuple, host: str) -> int:
        blob = f"{self.seed}|{host}|{key!r}".encode()
        return int.from_bytes(hashlib.md5(blob).digest()[:8], "big")

    def route(self, key: tuple) -> str:
        if not self._hosts:
            raise RuntimeError("fleet has no hosts to route to")
        return max(self._hosts, key=lambda h: (self.weight(key, h), h))


@dataclasses.dataclass
class WorkStealer:
    """Deterministic shard rebalancing policy (pure planning, no state).

    ``plan`` pairs each idle thief (queue at most ``idle_depth``, nothing in
    flight) with the then-deepest victim and moves up to ``max_steal``
    entries — half the victim's queue. A victim must hold at least
    ``min_queue`` queued entries. Victims holding URGENT entries
    (``HostLoad.urgent``) are preferred over merely deep ones."""

    min_queue: int = 2
    max_steal: int = 8
    idle_depth: int = 0

    def plan(self, loads: Mapping[str, HostLoad],
             thieves: Optional[Sequence[str]] = None) -> list[tuple[str, str, int]]:
        """Moves ``(victim, thief, n)`` for one steal round — a pure function
        of the load snapshot (hosts visited in sorted order). ``thieves``
        overrides idleness detection."""
        if self.max_steal < 1:
            return []
        depth = {h: loads[h].queue_depth for h in loads}
        if thieves is None:
            thieves = [h for h in sorted(loads)
                       if loads[h].queue_depth <= self.idle_depth
                       and loads[h].inflight == 0]
        moves: list[tuple[str, str, int]] = []
        for thief in sorted(thieves):
            if thief not in depth:
                continue
            victims = [h for h in sorted(depth)
                       if h != thief and h not in thieves
                       and depth[h] >= max(self.min_queue, 1)]
            if not victims:
                break
            victim = max(victims, key=lambda h: (
                getattr(loads[h], "urgent", 0), depth[h], h))
            n = min(self.max_steal, (depth[victim] + 1) // 2)
            if n < 1:
                continue
            depth[victim] -= n
            moves.append((victim, thief, n))
        return moves


@dataclasses.dataclass
class _Host:
    """One federated host: its gateway (whose queue is this host's shard)."""

    name: str
    gateway: GatewayBase
    routed: int = 0          # requests homed here by the router


class FleetGateway:
    """N per-host gateways behind one ``submit(request) -> Future``.

    ``hosts`` maps name -> gateway (or is a sequence, named ``h0..hN-1``).
    All hosts must serve the same solver (the router may send any request
    anywhere). Registration calls ``GatewayBase.federate`` on each host, so
    build hosts fresh and submit only through the fleet. ``seed`` seeds the
    router; ``base_seed`` is the fleet-wide base seed requests without
    ``x0`` or ``seed`` fold their uid into (a lone ``Gateway``'s ``seed``).

    Manual mode: ``pump()`` ticks every host once plus one steal round.
    Threaded mode: ``start()`` runs each host's serve thread plus a balancer
    thread running steal rounds. ``drain(timeout=)`` bounds the whole drain.
    """

    def __init__(self, hosts: Union[Mapping[str, GatewayBase], Sequence[GatewayBase]], *,
                 router: Optional[FleetRouter] = None,
                 stealer: Optional[WorkStealer] = None,
                 steal: bool = True,
                 affinity: Optional[Callable] = None,
                 base_seed: int = 0, seed: int = 0,
                 metrics: Optional[MetricsRegistry] = None, recorder=None):
        if not isinstance(hosts, Mapping):
            hosts = {f"h{i}": gw for i, gw in enumerate(hosts)}
        if not hosts:
            raise ValueError("a fleet needs at least one host")
        self.router = router if router is not None else FleetRouter(seed=seed)
        self.stealer = (stealer if stealer is not None
                        else WorkStealer() if steal else None)
        self._affinity = affinity
        self._base_seed = base_seed
        self._uids = itertools.count()   # ONE uid namespace across shards
        self._lock = threading.RLock()   # membership + routing + intake
        # the fleet's own counters (stealing, rerouting); the rest lives in
        # the per-host registries and is merged at snapshot time
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._stats_lock = self.metrics.lock
        self._m_steals = self.metrics.counter(
            "steals", "entries migrated by the work stealer")
        self._m_steal_rounds = self.metrics.counter(
            "steal_rounds", "rebalance rounds that moved >= 1 entry")
        self._m_rerouted = self.metrics.counter(
            "rerouted", "entries re-homed by a host leave")
        # ONE recorder fleet-wide: every host stamps its events with its name
        self.recorder = recorder if recorder is not None else NULL_RECORDER
        self._hosts: dict[str, _Host] = {}
        self._closed = False
        self._running = False
        self._poll_s = 0.001
        self._stop = threading.Event()
        self._balancer: Optional[threading.Thread] = None
        for name, gw in hosts.items():
            self.add_host(name, gw)

    # -- membership ----------------------------------------------------------

    def add_host(self, name: str, gateway: GatewayBase) -> None:
        """Join ``name``: share the uid namespace and base seed, enter the
        routing table, and start its serve thread if the fleet is running."""
        with self._lock:
            if self._closed:
                raise RuntimeError("fleet is draining; no new hosts")
            if name in self._hosts:
                raise ValueError(f"host {name!r} already in the fleet")
            gateway.federate(self._uids, self._base_seed,
                             recorder=self.recorder if self.recorder else None,
                             host=name)
            self.router.add(name)
            self._hosts[name] = _Host(name=name, gateway=gateway)
            if self._running:
                gateway.start(self._poll_s)

    def remove_host(self, name: str, timeout: Optional[float] = None) -> GatewayBase:
        """Graceful leave. Under the fleet lock: stop routing to ``name`` and
        migrate its whole queue shard to the survivors (re-homed by entry
        affinity). Outside the lock: drain its in-flight work (bounded by
        ``timeout``; ``DrainTimeout`` on a wedged engine) and stop its
        thread. Returns the detached, closed gateway."""
        with self._lock:
            if name not in self._hosts:
                raise KeyError(f"host {name!r} not in the fleet")
            if len(self._hosts) == 1:
                raise RuntimeError("cannot remove the last host; drain the fleet instead")
            host = self._hosts.pop(name)
            self.router.remove(name)
            moved = host.gateway.steal(None)         # the whole shard
            by_dest: dict[str, list] = {}
            for e in moved:
                by_dest.setdefault(self.router.route(entry_affinity(e)), []).append(e)
            for dest, es in by_dest.items():
                self._hosts[dest].gateway.inject(es)
        if moved:
            self._m_rerouted.inc(len(moved))
        host.gateway.drain(timeout=timeout)
        host.gateway.stop()
        return host.gateway

    @property
    def hosts(self) -> tuple[str, ...]:
        with self._lock:
            return tuple(sorted(self._hosts))

    # -- intake --------------------------------------------------------------

    def _key_of(self, request) -> tuple:
        if self._affinity is not None:
            return self._affinity(request)
        gw = next(iter(self._hosts.values())).gateway
        sampler = getattr(gw, "sampler", None)
        top = getattr(sampler, "budgets", (None,))[-1]
        return default_affinity(request, top_budget=top, tiers=getattr(gw, "tiers", None))

    def home(self, request) -> str:
        """The deterministic home host for ``request`` (no submission)."""
        with self._lock:
            return self.router.route(self._key_of(request))

    def submit(self, request=None, **kw) -> Future:
        """Route one request to its home shard, under the fleet lock, so the
        fleet-wide submission order (the shared uid order that folded noise
        seeds follow) is well defined."""
        if request is None:
            request = Request(**kw)
        with self._lock:
            if self._closed:
                raise RuntimeError("fleet is draining; no new requests")
            host = self._hosts[self.router.route(self._key_of(request))]
            future = host.gateway.submit(request)
            host.routed += 1
            rec = self.recorder
            if rec:
                rec.event(future.uid, "route", host.gateway.clock(), host=host.name)
        return future

    def submit_stream(self, request=None, **kw) -> ResponseStream:
        """Streamed submit: routes like ``submit`` and returns the home
        gateway's ``ResponseStream``; the sink rides the entry, so a stolen
        streamed request keeps emitting to the same stream."""
        if request is None:
            with self._lock:
                rtype = next(iter(self._hosts.values())).gateway._request_type
            request = rtype(**kw)
        request.stream = True
        future = self.submit(request)
        return ResponseStream(future, future.stream_sink)

    # -- stealing ------------------------------------------------------------

    def steal_round(self, thieves: Optional[Sequence[str]] = None) -> int:
        """One rebalancing round; returns entries moved."""
        if self.stealer is None:
            return 0
        with self._lock:
            gateways = {n: h.gateway for n, h in self._hosts.items()}
        loads = {n: gw.load() for n, gw in gateways.items()}
        moved = 0
        for victim, thief, n in self.stealer.plan(loads, thieves=thieves):
            entries = gateways[victim].steal(n)
            if not entries:
                continue                  # victim flushed them first: fine
            try:
                gateways[thief].inject(entries)
            except RuntimeError:
                try:                      # thief began draining mid-round
                    gateways[victim].inject(entries)
                except RuntimeError as exc:
                    # both shards closed between plan and move: an entry must
                    # never vanish with a live future
                    gateways[victim]._fail_entries(entries, exc, count_all=True)
            else:
                moved += len(entries)
        if moved:
            with self._stats_lock:
                self._m_steals.inc(moved)
                self._m_steal_rounds.inc()
        return moved

    # -- manual engine tick (fake clock) -------------------------------------

    def pump(self, force: bool = False, hosts: Optional[Sequence[str]] = None) -> int:
        """Tick the named (default: all) hosts once, then one steal round;
        returns dispatches run plus entries migrated."""
        with self._lock:
            selected = [self._hosts[n].gateway
                        for n in (hosts if hosts is not None else sorted(self._hosts))
                        if n in self._hosts]
        ran = sum(gw.pump(force=force) for gw in selected)
        return ran + self.steal_round()

    # -- lifecycle -----------------------------------------------------------

    def start(self, poll_s: float = 0.001, balance_s: float = 0.002) -> None:
        """Start every host's serve thread plus the fleet balancer."""
        with self._lock:
            self._running = True
            self._poll_s = poll_s
            for h in self._hosts.values():
                h.gateway.start(poll_s)
        if self._balancer is None or not self._balancer.is_alive():
            self._stop.clear()

            def balance():
                while not self._stop.is_set():
                    self.steal_round()
                    time.sleep(balance_s)

            self._balancer = threading.Thread(target=balance, name="fleet-balance",
                                              daemon=True)
            self._balancer.start()

    def drain(self, timeout: Optional[float] = None) -> None:
        """Refuse new requests, then drain every shard. ``timeout`` bounds the
        WHOLE drain (hosts share what remains; a host reaching zero raises
        ``DrainTimeout``, later hosts' queued entries stay safe)."""
        with self._lock:
            self._closed = True
            hosts = [h.gateway for _, h in sorted(self._hosts.items())]
        deadline = None if timeout is None else time.monotonic() + max(timeout, 0.0)
        for gw in hosts:
            gw.drain(timeout=None if deadline is None
                     else max(deadline - time.monotonic(), 0.0))

    def stop(self) -> None:
        self._stop.set()
        if self._balancer is not None:
            self._balancer.join(timeout=10)
            self._balancer = None
        with self._lock:
            self._running = False
            hosts = list(self._hosts.values())
        for h in hosts:
            h.gateway.stop()

    def shutdown(self, timeout: Optional[float] = None) -> None:
        self.drain(timeout=timeout)
        self.stop()

    # -- metrics -------------------------------------------------------------

    def metrics_snapshot(self) -> dict:
        """The MERGE of every host's registry snapshot plus the fleet's own:
        counters and gauges sum, histograms merge bucket-wise."""
        with self._lock:
            snaps = [h.gateway.metrics.snapshot() for _, h in sorted(self._hosts.items())]
        snaps.append(self.metrics.snapshot())
        return merge_snapshots(snaps)

    def stats(self) -> dict:
        """``stats_projection`` over the merged per-host snapshots, plus the
        shard view: ``queue_depths``, ``routed``, steal totals and each
        host's own ``stats()`` under ``per_host``."""
        with self._lock:
            items = sorted(self._hosts.items())
            per_host = {n: dict(h.gateway.stats(), routed=h.routed) for n, h in items}
            snaps = [h.gateway.metrics.snapshot() for _, h in items]
            clock = items[0][1].gateway.clock
            started = min(h.gateway._started for _, h in items)
        snaps.append(self.metrics.snapshot())
        merged = merge_snapshots(snaps)
        out = stats_projection(merged, clock() - started)
        out.update({
            "hosts": len(per_host),
            "queue_depths": {n: s["queue_depth"] for n, s in per_host.items()},
            "routed": {n: s["routed"] for n, s in per_host.items()},
            "steals": int(merged.get("steals", 0)),
            "steal_rounds": int(merged.get("steal_rounds", 0)),
            "rerouted": int(merged.get("rerouted", 0)),
            "per_host": per_host,
        })
        return out
