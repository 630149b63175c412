"""The port's copy of ``repro.observability.trace`` (stdlib only).

Per-request tracing: a bounded ring of lifecycle events.

Every gateway tier stamps events against the request uid (uids are
fleet-global after ``federate``, so one recorder shared across hosts
reconstructs a stolen request hop-by-hop: submit -> route -> steal ->
inject -> dispatch -> settle).

The disabled path is ``NULL_RECORDER``: falsy, every method a no-op.
Hot paths are written as::

    rec = self.recorder
    if rec:
        rec.event(uid, "dispatch", t, host=self._host)

so with tracing off the cost is one attribute read and one truth test —
no argument tuples, no dict building, zero allocations.
"""
from __future__ import annotations

import collections
import json
import threading
from typing import Dict, List, Optional


class NullRecorder:
    """Disabled recorder: falsy, allocation-free no-ops."""

    enabled = False

    def __bool__(self) -> bool:
        return False

    def event(self, uid, name, t, host="", **data) -> None:
        pass

    def trace(self, uid) -> list:
        return []

    def events(self) -> list:
        return []

    def open_spans(self) -> dict:
        return {}

    def export_jsonl(self, path) -> int:
        return 0


NULL_RECORDER = NullRecorder()


class TraceRecorder:
    """Bounded ring buffer of ``(t, uid, host, event, data)`` tuples.

    ``capacity`` bounds memory: the oldest events fall off first, so a
    long-running server keeps the most recent requests reconstructable
    without ever growing. All methods are thread-safe; ``event`` is a
    single locked deque append on the hot path.
    """

    enabled = True

    def __init__(self, capacity: int = 4096) -> None:
        self.capacity = capacity
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()

    def __bool__(self) -> bool:
        return True

    def event(self, uid: int, name: str, t: float, host: str = "",
              **data) -> None:
        with self._lock:
            self._ring.append((t, uid, host, name, data or None))

    @staticmethod
    def _as_dict(ev) -> dict:
        t, uid, host, name, data = ev
        d = {"t": t, "uid": uid, "host": host, "event": name}
        if data:
            d.update(data)
        return d

    def events(self) -> List[dict]:
        """All retained events, oldest first."""
        with self._lock:
            ring = list(self._ring)
        return [self._as_dict(ev) for ev in ring]

    def trace(self, uid: int) -> List[dict]:
        """The retained lifecycle of one request, oldest first."""
        with self._lock:
            ring = list(self._ring)
        return [self._as_dict(ev) for ev in ring if ev[1] == uid]

    def open_spans(self) -> Dict[int, List[dict]]:
        """Events of requests that have not settled — what a hung drain
        was still waiting on (attached to ``DrainTimeout``)."""
        by_uid: Dict[int, List[dict]] = {}
        settled = set()
        for d in self.events():
            by_uid.setdefault(d["uid"], []).append(d)
            if d["event"] == "settle":
                settled.add(d["uid"])
        return {uid: evs for uid, evs in by_uid.items()
                if uid not in settled}

    def export_jsonl(self, path: str,
                     uid: Optional[int] = None) -> int:
        """Write retained events (optionally one uid's) as JSON lines;
        returns the number of lines written."""
        events = self.trace(uid) if uid is not None else self.events()
        with open(path, "w") as f:
            for d in events:
                f.write(json.dumps(d, sort_keys=True) + "\n")
        return len(events)


def read_jsonl(path: str) -> List[dict]:
    """Load an ``export_jsonl`` file back into event dicts."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out
