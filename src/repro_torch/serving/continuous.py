"""Continuous batching: admit requests into in-flight anytime trajectories.

Port of ``repro.serving.continuous``. The flush-only gateway
(``serving.gateway``) exploits the anytime solver's shared trajectory only
at flush time: a request arriving one tick after a flush waits a full
``max_wait_ms`` even though an in-flight trajectory is passing an exit
boundary it could join. This module turns the solver's nested-grid
structure into request-level continuous batching:

* An in-flight anytime dispatch is tracked as a SEQUENCE OF EXIT-BOUNDARY
  JOIN POINTS — the trajectory advances leg by leg between consecutive
  served budgets, returning control to the host at every boundary.
* At each boundary k the engine RELEASES the slots whose served budget is k
  (their early-exit output resolves the future immediately) and ADMITS
  queued requests with budget > k into the freed slots: a joiner's prefix
  ``0..k`` is computed from its OWN noise on the shared intermediate rules,
  then steps ``k..b`` ride the shared grid with the rest of the batch.
* Every served sample equals the direct sampler's with the same noise —
  the exit-boundary join invariant of ``core.anytime.anytime_extend`` — and
  a joined request at budget b adds at most b incremental backbone forwards
  (k for the prefix dispatch; the shared legs are already being paid for).

``ContinuousScheduler`` extends ``BatchScheduler`` with slot admission and
release planning (pure functions of pending + now — fake-clock testable);
``ContinuousGateway.pump`` interleaves trajectory legs, joins, and the
inherited flush planning, so requests that cannot join (budget at or below
the next boundary, or no free slot) still flush under the usual
max-batch/max-wait rules. ``stats()`` additionally reports join-rate and
slot-occupancy.

Shape tiers (``serving.tiers``): with a ``ShapeLadder`` configured,
``shape_key`` holds the tier-padded shape, so trajectories are PER-TIER —
a joiner of any native shape in the tier rides the shared ``AnytimeCarry``
through its zero-padded position rows, and every release/partial crops
back to the entry's ``native_shape`` before the caller sees it.

Samplers must speak the carry protocol on top of the budget protocol:
``carry_start(batch, x0)`` and ``carry_extend(batch, carry, stop)``
(``AnytimeFlowSampler``; the reference jit-caches one program per (start,
stop) leg, the port runs each leg eagerly). The carry lives on the
sampler's device. A join writes the joiners' columns into CLONES of the
carry's tensors (the reference's functional ``.at[].set``), and a preempted
slot's column is copied to the host (``PausedCarry``), never kept as a
view. Each leg's time (``device_dispatch_ms``) ends after its exits reach
the host, or after the card finishes when no slot exits.

With ``mesh=`` the carry tensors are re-placed on the serving mesh after a
trajectory opens and after every join scatter (``sharded.carry_placer``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.observability import profile_span
from repro_torch.serving.gateway import (
    EXEC_LOCK,
    BatchScheduler,
    Gateway,
    Response,
    _Entry,
    assemble_rows,
    mesh_scope,
    to_device,
    to_host,
)
from repro_torch.serving.slo import PausedCarry, is_urgent, urgency_key
from repro_torch.serving.tiers import crop_row


class ContinuousScheduler(BatchScheduler):
    """Slot admission/release planning on top of flush planning.

    ``plan_start`` decides when pending requests open a new trajectory;
    ``plan_joins`` decides which requests are admitted into an in-flight one
    at an exit boundary. Both are pure functions of (pending, now, slot
    state) — the unit tests drive them with a fake clock and assert the
    exact slate. The inherited ``plan`` keeps serving whatever cannot ride
    a trajectory.
    """

    def __init__(self, max_slots: int = 8, boundaries: Sequence[int] = (),
                 max_batch: Optional[int] = None, max_wait_ms: float = 10.0,
                 policy: str = "auto", can_mix: bool = False,
                 top_budget: Optional[int] = None,
                 max_leg: Optional[int] = None,
                 join_cost_cap: float = 0.5, slo_aware: bool = False):
        super().__init__(max_batch=max_batch or max_slots,
                         max_wait_ms=max_wait_ms, policy=policy,
                         can_mix=can_mix, top_budget=top_budget,
                         slo_aware=slo_aware)
        if max_slots < 1:
            raise ValueError("max_slots must be >= 1")
        if max_leg is not None and max_leg < 1:
            raise ValueError("max_leg must be >= 1")
        if not 0.0 < join_cost_cap <= 1.0:
            raise ValueError("join_cost_cap must be in (0, 1]")
        self.max_slots = max_slots
        self.boundaries = tuple(sorted(boundaries))
        self.max_leg = max_leg
        self.join_cost_cap = join_cost_cap
        self._join_buckets = self._bucket_sizes(max_slots)

    def join_bucket(self, count: int) -> int:
        """Smallest padded size for a join-prefix dispatch — powers of two
        up to ``max_slots``, so each (boundary, bucket) prefix is one
        dispatch shape (mirrors ``bucket`` for flush batches)."""
        for b in self._join_buckets:
            if b >= count:
                return b
        raise ValueError(f"count {count} exceeds max_slots {self.max_slots}")

    def next_boundary(self, step: int) -> Optional[int]:
        """The next stop strictly beyond ``step`` (None past the top): the
        first exit boundary, clipped to ``max_leg`` steps when set — a
        shorter leg is not a join point, but it hands control back to the
        host so interleaved flushes are not blocked behind a long leg."""
        for b in self.boundaries:
            if b > step:
                return min(b, step + self.max_leg) if self.max_leg else b
        return None

    def plan_start(self, pending: Sequence[_Entry], now: float,
                   force: bool = False) -> list[_Entry]:
        """The FIFO slate opening a new trajectory: same-shape entries, up
        to ``max_slots``, once the slots would fill or the oldest entry of
        that shape has aged out (the same full-or-aged rule
        ``BatchScheduler.plan`` applies to flushes).

        Shape groups are considered INDEPENDENTLY, oldest group first, so an
        unaged singleton of one shape never parks a full (or aged) slate of
        another. SLO mode additionally starts as soon as any URGENT entry
        (deadline or raised priority) is queued: ``plan_start`` only runs
        when no trajectory is in flight, and an under-filled trajectory
        costs nothing extra (its free slots refill at every exit
        boundary)."""
        groups: dict[tuple, list[_Entry]] = {}
        order = urgency_key if self.slo_aware else (lambda e: e.uid)
        for e in sorted(pending, key=order):
            groups.setdefault(e.shape_key, []).append(e)
        for same in groups.values():     # insertion order = oldest-first
            aged = any(now - e.t_submit >= self.max_wait_s for e in same)
            if self.slo_aware and not aged:
                aged = any(is_urgent(e) for e in same)
            if force or aged or len(same) >= self.max_slots:
                return same[:self.max_slots]
        return []

    @staticmethod
    def join_cost(e: _Entry, boundary: int) -> int:
        """Prefix forwards admitting ``e`` at ``boundary`` costs: a fresh
        join recomputes 0..boundary; a PREEMPTED entry paused at step s <=
        boundary resumes its saved carry and only pays s..boundary."""
        p = getattr(e, "paused", None)
        if p is not None and p.step <= boundary:
            return boundary - p.step
        return boundary

    def plan_joins(self, pending: Sequence[_Entry], boundary: int,
                   free_slots: int, shape_key: tuple) -> list[_Entry]:
        """Entries admitted into the in-flight trajectory at ``boundary``:
        FIFO entries (urgency-ordered in SLO mode) of the trajectory's
        shape whose served budget lies STRICTLY beyond the boundary and
        whose prefix is worth paying — admission requires ``join_cost <=
        join_cost_cap * served``. Capped by the freed slots; not age-gated
        — immediate admission is the latency win."""
        if free_slots <= 0:
            return []
        order = urgency_key if self.slo_aware else (lambda e: e.uid)
        ok = [e for e in sorted(pending, key=order)
              if e.shape_key == shape_key and e.served > boundary
              and self.join_cost(e, boundary)
              <= self.join_cost_cap * e.served]
        return ok[:free_slots]

    def plan_preemptions(self, pending: Sequence[_Entry], boundary: int,
                         active: Sequence[tuple], free_slots: int,
                         shape_key: tuple) -> list[tuple]:
        """Eviction triples ``(slot_idx, victim, urgent)`` at an exit
        boundary: each still-queued urgent entry that could join (same
        conditions as ``plan_joins``) displaces one STRICTLY-lower-
        priority occupied slot — lowest-priority, youngest victim first.
        Empty when free slots remain (``plan_joins`` already used them) or
        nothing queued outranks a resident."""
        if free_slots > 0 or not pending or not active:
            return []
        candidates = [e for e in sorted(pending, key=urgency_key)
                      if e.shape_key == shape_key and e.served > boundary
                      and self.join_cost(e, boundary)
                      <= self.join_cost_cap * e.served]
        victims = sorted(
            [(si, v) for si, v in active if v.served > boundary],
            key=lambda sv: (sv[1].priority, -sv[1].t_submit, -sv[1].uid))
        pairs = []
        for e in candidates:
            if not victims:
                break
            si, v = victims[0]
            if v.priority >= e.priority:
                break       # victims are sorted; nothing weaker remains
            victims.pop(0)
            pairs.append((si, v, e))
        return pairs


@dataclasses.dataclass
class _Trajectory:
    """One in-flight shared trajectory: the device carry plus per-slot host
    bookkeeping. ``entries[i] is None`` marks a free (padded) slot — its
    rows keep stale data, which is harmless because rows are independent
    through the backbone (the padded-batch contract)."""

    carry: object                     # sampler-level AnytimeCarry
    entries: list                     # Optional[_Entry] per slot
    shape_key: tuple
    tokens: Optional[np.ndarray]      # (slots, S) conditioning, or None

    def cond(self, device) -> Optional[dict]:
        """The slots' tokens on ``device`` (one copy a dispatch)."""
        if self.tokens is None:
            return None
        tokens = torch.from_numpy(self.tokens)
        return {"tokens": tokens if device is None else tokens.to(device)}

    def active(self) -> list[tuple[int, _Entry]]:
        return [(i, e) for i, e in enumerate(self.entries) if e is not None]

    def free_slots(self) -> list[int]:
        return [i for i, e in enumerate(self.entries) if e is None]


class ContinuousGateway(Gateway):
    """Gateway with continuous batching over one anytime sampler.

    Same intake/lifecycle as ``Gateway``; ``pump`` becomes one engine tick:

    * no trajectory in flight — open one from the pending queue
      (``plan_start``), or
    * advance the trajectory one leg to the next exit boundary, release the
      slots exiting there, admit joiners into the freed slots
      (``plan_joins`` + prefix dispatch), and then
    * run the inherited flush planner over whatever remains pending, so
      non-joinable requests (budget at or below the next boundary, no free
      slot, other sample shape) never wait on the trajectory.

    ``drain`` additionally runs the in-flight trajectory to completion.
    """

    def __init__(self, sampler, *, max_slots: int = 8,
                 max_batch: Optional[int] = None, max_wait_ms: float = 10.0,
                 mixed_budget_policy: str = "auto", strict_nfe: bool = False,
                 mesh=None, clock=None, seed: int = 0,
                 max_leg: Optional[int] = None, join_cost_cap: float = 0.5,
                 metrics=None, recorder=None, slo=None, tiers=None):
        for method in ("carry_start", "carry_extend"):
            if not hasattr(sampler, method):
                raise TypeError(
                    "continuous batching needs a resumable anytime sampler "
                    f"(missing {method!r}); use AnytimeFlowSampler or serve "
                    "through the flush-only Gateway")
        kw = {} if clock is None else {"clock": clock}
        super().__init__(sampler, max_batch=max_batch or max_slots,
                         max_wait_ms=max_wait_ms,
                         mixed_budget_policy=mixed_budget_policy,
                         strict_nfe=strict_nfe, mesh=mesh, seed=seed,
                         metrics=metrics, recorder=recorder, slo=slo,
                         tiers=tiers, **kw)
        self.scheduler = ContinuousScheduler(
            max_slots=max_slots, boundaries=sampler.budgets,
            max_batch=max_batch or max_slots, max_wait_ms=max_wait_ms,
            policy=mixed_budget_policy,
            can_mix=self.scheduler.can_mix,
            top_budget=max(sampler.budgets),
            max_leg=max_leg, join_cost_cap=join_cost_cap,
            slo_aware=slo is not None)
        self._traj: Optional[_Trajectory] = None
        # with a mesh, the slot-batched carry is re-placed on it after the
        # trajectory opens and after every join scatter
        self._place_carry = None
        if mesh is not None:
            from repro_torch.serving import sharded

            self._place_carry = sharded.carry_placer(mesh)

    # -- engine tick ---------------------------------------------------------

    def pump(self, force: bool = False) -> int:
        """One engine tick; returns how many dispatches ran (trajectory
        opens and legs count as one each, like flush batches). The
        trajectory's work runs under ``EXEC_LOCK`` as flush batches do."""
        with self._plan_lock:
            if self.slo is not None:
                self._shed_expired()
                self.scheduler.lead_ms = self._dispatch_cost_ms()
            with EXEC_LOCK, mesh_scope(self.mesh):
                ran = self._tick_trajectory(force)
            # interleave flushes: whatever neither joined nor started still
            # obeys the flush-only rules (full buckets now, partials aged)
            batches = self.scheduler.plan(
                self.queue.snapshot(), self.clock(), force=force)
            self._take([e for b in batches for e in b.entries])
        return ran + self._run_batches(batches)

    def _tick_trajectory(self, force: bool) -> int:
        """Advance the in-flight trajectory one leg, or open one; returns
        the dispatches run (caller holds ``_plan_lock`` and ``EXEC_LOCK``)."""
        ran = 0
        if self._traj is not None:
            try:
                self._advance_leg()
            except BaseException as exc:  # noqa: BLE001 — see below
                # a failing leg must not strand the slots' futures or kill
                # the serve thread (the trajectory twin of the flush-path
                # guard in Gateway._run_batches)
                self._fail_trajectory(exc)
            ran += 1
        if self._traj is None:
            # idle engine, or the trajectory just retired: a new slate gets
            # first claim on the pending queue — its slots refill at every
            # later boundary, so it outranks the flush planner
            starters = self.scheduler.plan_start(
                self.queue.snapshot(), self.clock(), force=force)
            if starters:
                self._take(starters)
                try:
                    self._start_trajectory(starters, self.clock())
                except BaseException as exc:  # noqa: BLE001
                    self._fail_entries(starters, exc, count_all=True)
                    self._settle(len(starters))
                    self._traj = None
                ran += 1
        return ran

    def _estimate_wait_ms(self, entry) -> float:
        """Continuous-tier admission cost model: slots refill at every
        exit boundary, so the queue drains at the OBSERVED device-time-per-
        settle rate (``device_dispatch_ms.sum`` over ``completed``). Before
        the first settle the inherited flush batch model — seeded by
        ``slo.default_cost_ms`` — stands in."""
        with self._stats_lock:
            completed = self._m.completed.value
            device_ms = self._m.device_dispatch_ms.sum
            inflight = self._inflight
        if completed and device_ms > 0.0:
            # work ahead of us = queued entries plus the trajectory rows
            # already off the queue but not yet settled
            ahead = self.queue.depth() + inflight
            return device_ms / completed * (ahead + 1)
        return super()._estimate_wait_ms(entry)

    def _start_trajectory(self, starters: list, now: float) -> None:
        """Open a trajectory over ``starters`` (costs no forwards — the
        first leg runs on the next tick; waits end here, at admission)."""
        slots = self.scheduler.max_slots
        pad = slots - len(starters)
        x0_np, tokens = assemble_rows(starters, slots)
        for e in starters:
            e.t_admit, e.join_step = now, 0
        traj = _Trajectory(carry=None, entries=list(starters) + [None] * pad,
                           shape_key=starters[0].shape_key, tokens=tokens)
        _, x0 = to_device(x0_np, None, self._device)
        with profile_span(f"continuous.start.k{slots}"):
            carry = self.sampler.carry_start(traj.cond(self._device), x0)
        if self._place_carry is not None:
            carry = self._place_carry(carry)
        traj.carry = carry
        self._traj = traj
        with self._stats_lock:
            self._m.trajectories.inc()
            self._note_program(f"start/k{slots}")
        rec = self.recorder
        if rec:
            for e in starters:
                rec.event(e.uid, "dispatch", now, host=self._host,
                          kind="traj_start")

    def _advance_leg(self) -> None:
        """Advance to the next exit boundary, release exiting slots, admit
        joiners into the freed slots."""
        traj = self._traj
        step = traj.carry.step
        boundary = self.scheduler.next_boundary(step)
        assert boundary is not None, "trajectory ran past the top budget"
        active = traj.active()
        # a max_leg-clipped stop is a control point, not an exit boundary:
        # nothing releases or joins there, but interleaved flushes can run
        is_exit = boundary in self.scheduler.boundaries
        released = [(si, e) for si, e in active
                    if is_exit and e.served == boundary]
        # streaming slots riding PAST this exit get the boundary's early-
        # exit latents as a partial (exactly the budget-`boundary` sample
        # for their noise — the anytime grid is nested)
        streaming = [(si, e) for si, e in active
                     if is_exit and e.sink is not None
                     and e.served > boundary]
        t0 = self.clock()   # gateway clock: fake-clock benches feed the
        #                     SLO cost model simulated dispatch times
        with profile_span(f"continuous.leg.{step}-{boundary}"):
            carry, exits = self.sampler.carry_extend(
                traj.cond(self._device), traj.carry, boundary)
            latents = None
            if released or streaming:
                latents = to_host(exits[boundary])   # waits for the card
            elif self._device is not None and self._device.type == "cuda":
                torch.cuda.synchronize(self._device)
        leg_ms = (self.clock() - t0) * 1e3
        traj.carry = carry
        with self._stats_lock:
            m = self._m
            m.legs.inc()
            m.forwards.inc(boundary - step)
            m.slot_steps_active.inc(len(active) * (boundary - step))
            m.slot_steps_total.inc(
                self.scheduler.max_slots * (boundary - step))
            m.device_dispatch_ms.observe(leg_ms)
            self._note_program(f"leg/{step}-{boundary}")
            if active and active[0][1].native_shape is not None:
                # per-tier occupancy, weighted by leg steps (the slot-
                # steps convention): native rows carried vs padded rows
                # paid for — slot padding AND tier padding in one ratio
                tier = traj.shape_key[1]
                steps = boundary - step
                self._note_tier(
                    tier,
                    steps * sum(e.native_shape[0] for _, e in active),
                    steps * self.scheduler.max_slots * tier[0])
        for si, e in streaming:
            e.sink.partial(crop_row(latents[si], e.native_shape),
                           boundary=boundary)
        for si, e in released:
            self._release(traj, si, e, crop_row(latents[si], e.native_shape),
                          boundary, len(active))
        if is_exit:
            joiners = self.scheduler.plan_joins(
                self.queue.snapshot(), boundary, len(traj.free_slots()),
                traj.shape_key)
            if joiners:
                self._take(joiners)
                try:
                    self._admit(traj, joiners, boundary)
                except BaseException as exc:  # noqa: BLE001
                    # joiners left the queue already; a failing prefix
                    # dispatch must reach their futures. The trajectory's
                    # own carry is untouched (assigned only after every
                    # scatter lands), so the in-flight slots roll on.
                    self._fail_entries(joiners, exc, count_all=True)
                    self._settle(len(joiners))
            if self.slo is not None and self.slo.preemption:
                self._preempt(traj, boundary)
        if not traj.active():
            self._traj = None

    def _release(self, traj: _Trajectory, si: int, e: _Entry, row,
                 boundary: int, batch_real: int) -> None:
        """Resolve one slot's future at its exit boundary and free the slot."""
        wait_ms = (e.t_admit - e.t_submit) * 1e3
        with self._stats_lock:
            # wait observed exactly where completed ticks, so the
            # histogram count == completed invariant holds tier-wide
            self._m.completed.inc()
            self._m.wait_ms.observe(wait_ms)
            self._note_deadline(e, self.clock())
            self._inflight -= 1      # taken at plan_start/plan_joins
        rec = self.recorder
        if rec:
            rec.event(e.uid, "settle", self.clock(), host=self._host,
                      status="completed", boundary=boundary, slot=si)
        response = Response(latents=row, meta={
            "requested_budget": e.requested,
            "served_budget": e.served,
            "nfe_batch": boundary,
            "batch_real": batch_real,
            "batch_padded": self.scheduler.max_slots,
            "mixed": False,
            "wait_ms": wait_ms,
            "continuous": True,
            "join_step": e.join_step,
            "slot": si,
        })
        if e.native_shape is not None:
            response.meta["tier_shape"] = e.shape_key[1]
            response.meta["native_shape"] = e.native_shape
        if e.trace and rec:
            response.trace = rec.trace(e.uid)
        try:
            e.future.set_result(response)
        except Exception:           # cancelled: the trajectory rolls on
            pass
        if e.sink is not None:
            e.sink.final(response)
        traj.entries[si] = None

    def _admit(self, traj: _Trajectory, joiners: list, boundary: int) -> None:
        """Join ``joiners`` at ``boundary``. Fresh joiners compute their
        prefix 0..boundary from their own noise on the shared intermediate
        rules (one padded mini-dispatch, ``boundary`` forwards); PREEMPTED
        joiners resume their saved carry from its paused step (``boundary
        - step`` forwards, zero when paused at this very boundary). Both
        land by writing per-slot carry columns into the freed slots of
        clones of the carry's tensors — equal to never having left the
        trajectory (the exit-boundary join invariant)."""
        dev = self._device
        fresh = [e for e in joiners
                 if e.paused is None or e.paused.step > boundary]
        resumed = [e for e in joiners
                   if e.paused is not None and e.paused.step <= boundary]
        cols: dict[int, tuple] = {}   # uid -> (x0 row, U column, x row)
        programs: list[str] = []
        prefix_forwards = 0
        if fresh:
            k = len(fresh)
            bucket = self.scheduler.join_bucket(k)
            cond, x0 = to_device(*assemble_rows(fresh, bucket), dev)
            if self._place is not None:
                cond, x0 = self._place(cond, x0)
            with profile_span(f"continuous.join.{boundary}/k{bucket}"):
                prefix = self.sampler.carry_start(cond, x0)
                prefix, _ = self.sampler.carry_extend(cond, prefix, boundary)
            prefix_forwards += boundary
            programs.append(f"join/{boundary}-k{bucket}")
            for i, e in enumerate(fresh):
                cols[e.uid] = (prefix.x0[i], prefix.U[:, i], prefix.x[i])
        by_step: dict[int, list] = {}
        for e in resumed:
            by_step.setdefault(e.paused.step, []).append(e)
        for s in sorted(by_step):
            group = by_step[s]
            k = len(group)
            bucket = self.scheduler.join_bucket(k)
            x0_np, u_np, x_np, t_np = self._stack_paused(group, bucket)
            cond, x0 = to_device(x0_np, t_np, dev)
            _, U = to_device(u_np, None, dev)
            _, x = to_device(x_np, None, dev)
            rcarry = type(traj.carry)(x0=x0, U=U, x=x, step=s)
            if self._place is not None:
                cond, _ = self._place(cond, x0)
                rcarry = self._place_carry(rcarry)
            if s < boundary:
                with profile_span(
                        f"continuous.resume.{s}-{boundary}/k{bucket}"):
                    rcarry, _ = self.sampler.carry_extend(cond, rcarry,
                                                          boundary)
                prefix_forwards += boundary - s
                programs.append(f"resume/{s}-{boundary}-k{bucket}")
            for i, e in enumerate(group):
                cols[e.uid] = (rcarry.x0[i], rcarry.U[:, i], rcarry.x[i])
        free = traj.free_slots()[:len(joiners)]
        carry = traj.carry
        idx = torch.tensor(free, device=carry.x0.device)
        # clones, not in-place writes: the old carry's tensors may still be
        # referenced (an earlier leg's exits, a resumed group's columns)
        x0 = carry.x0.clone()
        x0[idx] = torch.stack([cols[e.uid][0] for e in joiners])
        U = carry.U.clone()
        U[:, idx] = torch.stack([cols[e.uid][1] for e in joiners], dim=1)
        x = carry.x.clone()
        x[idx] = torch.stack([cols[e.uid][2] for e in joiners])
        carry = carry._replace(x0=x0, U=U, x=x)
        if self._place_carry is not None:
            carry = self._place_carry(carry)
        traj.carry = carry
        now = self.clock()
        rec = self.recorder
        for si, e in zip(free, joiners):
            if e.paused is None:
                # a resumed entry keeps its FIRST admission: its wait
                # ended then, and join_step records where it entered
                e.t_admit, e.join_step = now, boundary
            e.paused = None
            if traj.tokens is not None:
                traj.tokens[si] = np.asarray(e.tokens)
            traj.entries[si] = e
            if rec:
                rec.event(e.uid, "join", now, host=self._host,
                          boundary=boundary, slot=si,
                          resumed=e in resumed)
        with self._stats_lock:
            m = self._m
            m.joins.inc(len(joiners))
            m.forwards.inc(prefix_forwards)
            m.join_forwards.inc(prefix_forwards)
            for program in programs:
                self._note_program(program)

    @staticmethod
    def _stack_paused(group: list, bucket: int):
        """Rebuild padded batch arrays from saved ``PausedCarry`` columns
        (the resume twin of ``assemble_rows``): stack each victim's x0
        row, recorded-velocity column, and state row, zero-padded to
        ``bucket`` — pad rows are independent through the backbone, so
        they never perturb a resumed sample."""
        pad = bucket - len(group)
        x0 = np.stack([np.asarray(e.paused.x0) for e in group])
        u = np.stack([np.asarray(e.paused.U) for e in group], axis=1)
        x = np.stack([np.asarray(e.paused.x) for e in group])
        if pad:
            x0 = np.concatenate(
                [x0, np.zeros((pad,) + x0.shape[1:], x0.dtype)])
            u = np.concatenate(
                [u, np.zeros((u.shape[0], pad) + u.shape[2:], u.dtype)],
                axis=1)
            x = np.concatenate(
                [x, np.zeros((pad,) + x.shape[1:], x.dtype)])
        tokens = None
        if group[0].tokens is not None:
            tokens = np.stack(
                [np.asarray(e.tokens) for e in group]
                + [np.zeros_like(np.asarray(group[0].tokens))] * pad)
        return x0, u, x, tokens

    def _preempt(self, traj: _Trajectory, boundary: int) -> None:
        """Evict strictly-lower-priority slots for queued urgent entries at
        an exit boundary (``plan_preemptions``), then admit the urgent
        entries into the freed slots. Each victim's carry column is
        copied to the host (``PausedCarry``) and the victim goes BACK to
        the queue; a later ``plan_joins`` resumes it for only the
        boundary-gap forwards, bit-identical to an unpreempted run."""
        pairs = self.scheduler.plan_preemptions(
            self.queue.snapshot(), boundary, traj.active(),
            len(traj.free_slots()), traj.shape_key)
        if not pairs:
            return
        carry = traj.carry
        rec = self.recorder
        now = self.clock()
        urgents = []
        for si, victim, urgent in pairs:
            victim.paused = PausedCarry(
                step=boundary,
                x0=to_host(carry.x0[si]),
                U=to_host(carry.U[:, si]),
                x=to_host(carry.x[si]))
            traj.entries[si] = None
            # back to the queue: still accepted (submitted already
            # counted), no longer in flight until it rejoins
            self.queue.push(victim)
            self._settle(1)
            urgents.append(urgent)
            if rec:
                rec.event(victim.uid, "preempt", now, host=self._host,
                          boundary=boundary, slot=si, by=urgent.uid)
        with self._stats_lock:
            self._m.preemptions.inc(len(pairs))
        self._take(urgents)
        try:
            self._admit(traj, urgents, boundary)
        except BaseException as exc:  # noqa: BLE001 — mirror plan_joins
            self._fail_entries(urgents, exc, count_all=True)
            self._settle(len(urgents))

    def _fail_trajectory(self, exc: BaseException) -> None:
        """Surface a failing leg into every occupied slot's future and
        retire the trajectory, keeping the engine (and its serve thread)
        alive — the trajectory twin of ``_run_batches``' per-batch guard."""
        traj, self._traj = self._traj, None
        if traj is not None:
            entries = [e for _, e in traj.active()]
            self._fail_entries(entries, exc, count_all=True)
            self._settle(len(entries))

    # -- lifecycle -----------------------------------------------------------

    def _drained(self) -> bool:
        """Drain additionally runs the in-flight trajectory to completion
        (its slots are in flight anyway — belt and braces)."""
        return super()._drained() and self._traj is None
