"""The port's copy of ``repro.serving.slo`` (stdlib only), served through
every gateway tier: ``Gateway``, ``ContinuousGateway`` (which also preempts
slots at exit boundaries into a host ``PausedCarry``) and ``DecodeGateway``.

SLO policy: deadlines, priorities, admission control, shedding.

FIFO-with-aging collapses under overload: the queue grows without bound,
every request is eventually served LATE, and the forwards spent on hopeless
requests starve the feasible ones. This module holds the pure policy the
gateways consult when a ``SLOConfig`` is attached:

* **Deadlines.** ``Request.deadline_ms`` / ``DecodeRequest.deadline_ms``
  is a relative budget (ms from submit); the gateway stamps the absolute
  deadline on its own clock, so fake-clock benches measure SLO attainment
  deterministically. Settling on time ticks ``goodput``; settling late
  (or being shed) ticks ``deadline_misses``.
* **Admission control.** ``submit`` fast-rejects with ``AdmissionRejected``
  when the queue's MODELED service time cannot meet the deadline. The cost
  model is the registry's own observed dispatch-time histograms
  (``device_dispatch_ms`` + ``host_assembly_ms`` means — see
  ``GatewayBase._dispatch_cost_ms``), so it calibrates itself from live
  traffic: no configuration, and on the fake clock it sees simulated
  milliseconds, making the overload bench deterministic.
* **Shedding.** A queued entry whose deadline already passed is failed
  with ``DeadlineExceeded`` at the next pump instead of burning a slot —
  under overload the forwards saved go to requests that can still win.
* **Ordering.** ``urgency_key`` sorts higher priority first, then earlier
  deadline, then FIFO — entries with no deadline and priority 0 keep the
  exact legacy ``(t_submit, uid)`` order, so attaching an ``SLOConfig``
  never reorders plain traffic.
* **Preemption** (continuous tier). At an anytime exit boundary a queued
  urgent entry may evict a strictly-lower-priority slot. The victim's
  carry column is copied to the host (``PausedCarry``) and it goes back to
  the queue; resuming rebuilds the column and continues bit-identically
  (the exit-boundary join invariant), paying only the boundary gap.
Everything here is a pure function of (entries, clock, config) — the unit
tests drive it with a fake clock.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional


class AdmissionRejected(RuntimeError):
    """Fast reject at ``submit``: the queue's modeled service time cannot
    meet the request's deadline. Raised synchronously — the caller never
    gets a future — and counted under the ``rejected`` metric (NOT
    ``submitted``/``failed``: the request was never accepted)."""

    def __init__(self, message: str, *, estimated_ms: float = 0.0,
                 deadline_ms: float = 0.0, queue_depth: int = 0):
        super().__init__(message)
        self.estimated_ms = estimated_ms
        self.deadline_ms = deadline_ms
        self.queue_depth = queue_depth


class DeadlineExceeded(RuntimeError):
    """An ACCEPTED request was shed because its deadline passed while it
    was still queued. Surfaces through the future (counted under both
    ``failed`` and ``deadline_misses``)."""


@dataclasses.dataclass(frozen=True)
class SLOConfig:
    """Switchboard for the SLO behaviours. ``slo=None`` on a gateway is
    exact legacy FIFO (deadline metrics are still recorded — the overload
    bench's baseline arm); ``slo=SLOConfig()`` turns everything on.

    ``slack_ms`` is a safety margin subtracted from every deadline before
    the admission/shedding comparison. ``default_cost_ms`` seeds the cost
    model before the first dispatch has been observed (0 = optimistic:
    accept everything until the histograms warm up).
    """

    admission: bool = True      # fast-reject at submit
    shedding: bool = True       # fail queued entries past their deadline
    preemption: bool = True     # evict low-priority continuous slots
    slack_ms: float = 0.0
    default_cost_ms: float = 0.0


def urgency_key(entry) -> tuple:
    """Sort key: higher priority first, earlier deadline first, then the
    legacy FIFO ``(t_submit, uid)`` — default entries (priority 0, no
    deadline) order exactly as before."""
    deadline = getattr(entry, "deadline", None)
    return (-getattr(entry, "priority", 0),
            deadline if deadline is not None else math.inf,
            entry.t_submit, entry.uid)


def is_urgent(entry) -> bool:
    """Queued entries that carry SLO pressure — what ``HostLoad.urgent``
    counts and the work stealer prefers to migrate."""
    return (getattr(entry, "priority", 0) > 0
            or getattr(entry, "deadline", None) is not None)


def hist_mean(hist_handle) -> Optional[float]:
    """Mean of a live ``Histogram`` handle (exact — count/sum are tracked
    outside the buckets); None before the first observation."""
    if hist_handle.count == 0:
        return None
    return hist_handle.sum / hist_handle.count


@dataclasses.dataclass(frozen=True)
class PausedCarry:
    """Host-side snapshot of one preempted slot, taken at an exit
    boundary: the victim's carry COLUMN (its x0 row, its recorded-velocity
    column ``U[:, slot]``, its current state row) plus the boundary it was
    paused at. Each array is a numpy COPY on the host, never a view of the
    device carry, which later joins overwrite. Resuming rebuilds a mini
    ``AnytimeCarry`` at ``step=step`` from exactly these arrays, so the
    resumed trajectory is bit-identical to one that was never preempted."""

    step: int
    x0: object       # np.ndarray, the entry's own noise row
    U: object        # np.ndarray (n, *dim): recorded velocities, rows >= step zero
    x: object        # np.ndarray: state at ``step``
