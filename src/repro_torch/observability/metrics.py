"""The port's copy of ``repro.observability.metrics`` (stdlib only).

Dependency-free metrics registry: Counter / Gauge / Histogram.

One ``MetricsRegistry`` per serving tier (``GatewayBase`` owns one;
``FleetGateway`` merges its hosts' snapshots).  Design constraints, in
order:

* **Deterministic.**  The fake-clock benches gate histogram bucket
  counts and interpolated percentiles against committed baselines, so
  every operation is exact integer/float arithmetic — no sampling, no
  reservoir, no decay.
* **Mergeable.**  ``snapshot()`` returns plain dicts of numbers (and
  histogram dicts) that ``merge_snapshots`` can sum across hosts —
  the fleet-wide p95 is computed from the SUMMED buckets, which is
  exact for bucketed histograms (unlike merging percentiles).
* **Cheap under one lock.**  The registry exposes its ``RLock`` so a
  gateway can alias its stats lock to it: a block of handle updates is
  then one atomic multi-metric transaction, and ``snapshot()`` sees a
  consistent cut (counters monotone, histogram count == settled).

Histograms use fixed log-spaced bucket bounds (``DEFAULT_MS_BOUNDS``:
quarter-millisecond lower edge, sqrt(2) growth) so two registries that
never exchanged state still merge exactly, and percentile error is
bounded by one bucket width.
"""
from __future__ import annotations

import threading
from bisect import bisect_left
from typing import Callable, Dict, List, Optional, Sequence, Tuple

# 0.25ms .. ~181s in sqrt(2) steps: 40 bounds + overflow bucket. Wide
# enough for fake-clock waits (ms) and real dispatch legs (s) alike.
DEFAULT_MS_BOUNDS: Tuple[float, ...] = tuple(
    0.25 * 2.0 ** (i / 2.0) for i in range(40))


def _label_key(name: str, labels: Optional[dict]) -> str:
    if not labels:
        return name
    inner = ",".join(f'{k}="{labels[k]}"' for k in sorted(labels))
    return f"{name}{{{inner}}}"


class Counter:
    """Monotone counter. ``inc`` only; never decremented or reset."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """Point-in-time value: ``set``/``add``, or a ``set_fn`` callback
    evaluated lazily at snapshot time (used for queue depth / in-flight
    counts that already live on the gateway — no double bookkeeping)."""

    __slots__ = ("value", "fn")

    def __init__(self) -> None:
        self.value = 0.0
        self.fn: Optional[Callable[[], float]] = None

    def set(self, v: float) -> None:
        self.value = v

    def add(self, d: float) -> None:
        self.value += d

    def set_fn(self, fn: Callable[[], float]) -> None:
        self.fn = fn

    def read(self) -> float:
        return float(self.fn()) if self.fn is not None else self.value


class Histogram:
    """Fixed-bound log-bucket histogram.

    ``buckets[i]`` counts observations ``<= bounds[i]`` (exclusive of
    lower buckets); ``buckets[-1]`` is the overflow bucket. Tracks
    ``count``/``sum``/``max`` exactly, so means and maxima are not
    subject to bucketing error — only percentiles are, and those are
    bounded by one bucket width.
    """

    __slots__ = ("bounds", "buckets", "count", "sum", "max")

    def __init__(self, bounds: Sequence[float] = DEFAULT_MS_BOUNDS) -> None:
        self.bounds = tuple(float(b) for b in bounds)
        self.buckets = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.sum = 0.0
        self.max = 0.0

    def observe(self, v: float) -> None:
        v = float(v)
        self.buckets[bisect_left(self.bounds, v)] += 1
        self.count += 1
        self.sum += v
        if v > self.max:
            self.max = v

    def percentile(self, q: float) -> float:
        return percentile_from_buckets(self.bounds, self.buckets, q,
                                       vmax=self.max)


def percentile_from_buckets(bounds: Sequence[float], buckets: Sequence[int],
                            q: float, vmax: Optional[float] = None) -> float:
    """Interpolated percentile from bucket counts.

    Finds the bucket containing the ``q``-th rank and interpolates
    linearly inside it; the overflow bucket reports ``vmax`` (the exact
    tracked maximum) when available, else the top bound. In-bucket
    interpolation can overshoot the true maximum when the rank lands in
    the max's own bucket, so the result is clamped to ``vmax``.
    """
    total = sum(buckets)
    if total == 0:
        return 0.0
    rank = (q / 100.0) * total
    cum = 0
    for i, c in enumerate(buckets):
        if c and cum + c >= rank:
            if i >= len(bounds):          # overflow bucket
                return float(vmax if vmax is not None else bounds[-1])
            lo = bounds[i - 1] if i > 0 else 0.0
            hi = bounds[i]
            frac = (rank - cum) / c
            val = lo + (hi - lo) * min(max(frac, 0.0), 1.0)
            return min(val, vmax) if vmax is not None else val
        cum += c
    return float(vmax if vmax is not None else bounds[-1])


def bucket_bounds_at(bounds: Sequence[float], buckets: Sequence[int],
                     q: float) -> Tuple[float, float]:
    """(lo, hi) edges of the bucket containing the ``q``-th rank —
    the "one bucket width" the percentile claim is measured against."""
    total = sum(buckets)
    if total == 0:
        return (0.0, 0.0)
    rank = (q / 100.0) * total
    cum = 0
    for i, c in enumerate(buckets):
        if c and cum + c >= rank:
            if i >= len(bounds):
                return (bounds[-1], float("inf"))
            return (bounds[i - 1] if i > 0 else 0.0, bounds[i])
        cum += c
    return (bounds[-1], float("inf"))


class MetricsRegistry:
    """Named metrics behind one re-entrant lock.

    Handles are get-or-create by ``(name, labels)`` and type-checked;
    ``snapshot()`` is a consistent cut of every metric plus a ``_meta``
    map (name -> type/help) that drives the Prometheus exposition.
    """

    def __init__(self) -> None:
        self.lock = threading.RLock()
        self._metrics: Dict[str, object] = {}
        self._meta: Dict[str, Dict[str, str]] = {}

    def _get(self, name: str, help: str, labels: Optional[dict],
             kind: str, factory):
        key = _label_key(name, labels)
        with self.lock:
            m = self._metrics.get(key)
            if m is None:
                m = factory()
                self._metrics[key] = m
                self._meta.setdefault(name, {"type": kind, "help": help})
            elif self._meta.get(name, {}).get("type") != kind:
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{self._meta[name]['type']}, not {kind}")
            return m

    def counter(self, name: str, help: str = "",
                labels: Optional[dict] = None) -> Counter:
        return self._get(name, help, labels, "counter", Counter)

    def gauge(self, name: str, help: str = "",
              labels: Optional[dict] = None) -> Gauge:
        return self._get(name, help, labels, "gauge", Gauge)

    def histogram(self, name: str, help: str = "",
                  labels: Optional[dict] = None,
                  bounds: Sequence[float] = DEFAULT_MS_BOUNDS) -> Histogram:
        return self._get(name, help, labels, "histogram",
                         lambda: Histogram(bounds))

    def snapshot(self) -> dict:
        """Consistent cut: ``{name_or_labelled_key: number | hist-dict}``
        plus ``"_meta"``. Histogram dicts carry bounds + buckets (for
        merging) and pre-interpolated p50/p95/p99."""
        out: dict = {}
        with self.lock:
            for key, m in self._metrics.items():
                if isinstance(m, Counter):
                    out[key] = m.value
                elif isinstance(m, Gauge):
                    out[key] = m.read()
                else:
                    out[key] = {
                        "count": m.count,
                        "sum": m.sum,
                        "max": m.max,
                        "bounds": list(m.bounds),
                        "buckets": list(m.buckets),
                        "p50": m.percentile(50.0),
                        "p95": m.percentile(95.0),
                        "p99": m.percentile(99.0),
                    }
            out["_meta"] = {n: dict(v) for n, v in self._meta.items()}
        return out


def merge_snapshots(snaps: Sequence[dict]) -> dict:
    """Merge per-host snapshots: counters/gauges sum, histograms sum
    bucket-wise (exact — bounds must match) with percentiles recomputed
    from the merged buckets. This is how ``FleetGateway`` reports: the
    fleet registry IS the merge of its hosts' registries."""
    out: dict = {"_meta": {}}
    for snap in snaps:
        for key, v in snap.items():
            if key == "_meta":
                out["_meta"].update(v)
                continue
            if isinstance(v, dict):      # histogram
                cur = out.get(key)
                if cur is None:
                    out[key] = {k: (list(x) if isinstance(x, list) else x)
                                for k, x in v.items()}
                    continue
                if list(cur["bounds"]) != list(v["bounds"]):
                    raise ValueError(f"histogram {key!r}: bounds differ, "
                                     f"cannot merge exactly")
                cur["count"] += v["count"]
                cur["sum"] += v["sum"]
                cur["max"] = max(cur["max"], v["max"])
                cur["buckets"] = [a + b for a, b in
                                  zip(cur["buckets"], v["buckets"])]
            else:
                out[key] = out.get(key, 0) + v
    for key, v in out.items():
        if key != "_meta" and isinstance(v, dict):
            for q in (50.0, 95.0, 99.0):
                v[f"p{int(q)}"] = percentile_from_buckets(
                    v["bounds"], v["buckets"], q, vmax=v["max"])
    return out


def _prom_escape(s: str) -> str:
    return s.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def to_prometheus(snapshot: dict, prefix: str = "repro") -> str:
    """Prometheus text exposition (v0.0.4) of a ``snapshot()`` dict."""
    meta = snapshot.get("_meta", {})
    lines: List[str] = []
    seen_header = set()

    def header(name: str, kind: str) -> None:
        if name in seen_header:
            return
        seen_header.add(name)
        info = meta.get(name, {})
        if info.get("help"):
            lines.append(f"# HELP {prefix}_{name} "
                         f"{_prom_escape(info['help'])}")
        lines.append(f"# TYPE {prefix}_{name} {kind}")

    for key in sorted(k for k in snapshot if k != "_meta"):
        v = snapshot[key]
        brace = key.find("{")
        name = key if brace < 0 else key[:brace]
        labels = "" if brace < 0 else key[brace:]
        kind = meta.get(name, {}).get("type", "untyped")
        header(name, kind)
        if isinstance(v, dict):
            inner = labels[1:-1] if labels else ""
            sep = "," if inner else ""
            cum = 0
            for bound, c in zip(v["bounds"], v["buckets"]):
                cum += c
                lines.append(f'{prefix}_{name}_bucket{{{inner}{sep}'
                             f'le="{bound:g}"}} {cum}')
            lines.append(f'{prefix}_{name}_bucket{{{inner}{sep}'
                         f'le="+Inf"}} {v["count"]}')
            lines.append(f"{prefix}_{name}_sum{labels} {v['sum']:g}")
            lines.append(f"{prefix}_{name}_count{labels} {v['count']}")
        else:
            lines.append(f"{prefix}_{name}{labels} {v:g}")
    return "\n".join(lines) + "\n"
