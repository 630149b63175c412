"""The port's copy of ``repro.observability.export`` (stdlib only).

Export surfaces: one stats-line formatter, a periodic printer, and
an HTTP endpoint serving Prometheus text + JSON snapshots.

``format_stats_line`` is THE formatter — serve.py's four per-mode stats
print blocks (gateway / continuous / decode / fleet) are all this one
function; the tier-specific segments switch on keys the compatibility
projection only emits for the tiers that have them (``trajectories``,
``tokens_out``, ``page_size``, ``hosts``).
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

from repro_torch.observability.metrics import to_prometheus


def format_stats_line(s: dict, prefix: str = "stats") -> str:
    """One line for any tier's ``stats()`` dict."""
    g = s.get
    parts = [
        f"{prefix}: done={g('completed', 0)}/{g('submitted', 0)}"
        f" q={g('queue_depth', 0)}"
        f" batches={g('batches', 0)}"
        f" mixed={g('mixed_batches', 0)}"
        f" forwards={g('forwards', 0)}"
        f" nfe/req={g('nfe_per_request', 0.0):.2f}"
        f" occ={g('occupancy', 0.0):.2f}"
        f" wait p50/p95/max="
        f"{g('wait_p50_ms', 0.0):.1f}/{g('wait_p95_ms', 0.0):.1f}"
        f"/{g('max_wait_ms', 0.0):.1f}ms"
        f" rps={g('throughput_rps', 0.0):.1f}"
    ]
    if g("trajectories", 0) and not g("tokens_out", 0):
        # the decode segment below already carries slot_occ/joins
        parts.append(
            f"traj={s['trajectories']} legs={g('legs', 0)}"
            f" joins={g('joins', 0)} join_rate={g('join_rate', 0.0):.2f}"
            f" slot_occ={g('slot_occupancy', 0.0):.2f}")
    if g("tokens_out", 0):
        parts.append(
            f"tokens={s['tokens_out']} tok/s={g('tokens_per_s', 0.0):.1f}"
            f" slot_occ={g('slot_occupancy', 0.0):.2f}"
            f" joins={g('joins', 0)} prefill={g('prefill_calls', 0)}"
            f" cancelled={g('cancelled', 0)}")
    if "page_size" in s:
        parts.append(
            f"paged page_size={s['page_size']}"
            f" pages={g('pages_in_use', 0)}/{g('peak_pages', 0)} peak"
            f" kv/slot={g('peak_kv_per_slot', 0.0):.1f}")
    if "hosts" in s:
        routed = s.get("routed", {})
        routed_txt = " ".join(f"{h}={n}" for h, n in sorted(routed.items()))
        parts.append(
            f"fleet hosts={s['hosts']} steals={g('steals', 0)}"
            f" rounds={g('steal_rounds', 0)} rerouted={g('rerouted', 0)}"
            + (f" routed: {routed_txt}" if routed_txt else ""))
    return " | ".join(parts)


class StatsPrinter:
    """Daemon thread printing ``line_fn()`` every ``interval_s``.

    ``serve.py --stats-interval N`` wires this around the traffic loop
    for every mode; it never prints concurrently with ``stop()``'s
    final flush.
    """

    def __init__(self, line_fn: Callable[[], str], interval_s: float,
                 log: Callable[[str], None] = print) -> None:
        self.line_fn = line_fn
        self.interval_s = max(float(interval_s), 1e-3)
        self.log = log
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "StatsPrinter":
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="stats-printer")
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.log(self.line_fn())
            except Exception as exc:           # keep serving regardless
                self.log(f"stats-printer error: {exc!r}")

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None


class MetricsServer:
    """Minimal stdlib HTTP endpoint: ``/metrics`` (Prometheus text
    exposition) and ``/metrics.json`` (raw snapshot). ``port=0`` binds
    an ephemeral port (``.port`` has the real one) — used by tests."""

    def __init__(self, snapshot_fn: Callable[[], dict], port: int = 0,
                 host: str = "127.0.0.1") -> None:
        self.snapshot_fn = snapshot_fn

        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self) -> None:
                try:
                    snap = outer.snapshot_fn()
                    if self.path.startswith("/metrics.json"):
                        body = json.dumps(snap, indent=2).encode()
                        ctype = "application/json"
                    elif self.path.startswith("/metrics"):
                        body = to_prometheus(snap).encode()
                        ctype = "text/plain; version=0.0.4"
                    else:
                        self.send_error(404)
                        return
                except Exception as exc:
                    self.send_error(500, repr(exc))
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a) -> None:   # no per-scrape stderr spam
                pass

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "MetricsServer":
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="metrics-server")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
