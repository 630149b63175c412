"""The port's copy of ``repro.serving.stream`` (stdlib only): the
continuous flow gateway streams exit-boundary partials through it, the
decode gateway tokens.

Streaming handles: incremental results riding the existing settle path.

``GatewayBase.submit_stream`` returns a ``ResponseStream`` — an iterator
of ``StreamChunk``s fed by the serving tiers at their natural progress
points:

* FLOW (``ContinuousGateway``): one ``partial`` chunk per anytime EXIT
  BOUNDARY the request's trajectory crosses before its own exit — the
  early-exit latents at budget k are exactly what a budget-k request with
  the same noise would have received (the anytime grid is nested), so
  every partial is itself a valid sample at a smaller NFE.
* DECODE (``DecodeGateway``): one ``partial`` chunk per generated token,
  emitted the same tick the token lands in ``slot.emitted``.

The TERMINAL chunk carries the very ``Response``/``DecodeResponse`` the
request's ``Future`` resolves with — streaming adds emission points but
never forks the settle path, so a streamed request's final result is
bit-identical to the plain ``submit`` of the same request (asserted in
``tests/test_torch_slo.py``, as ``tests/test_slo.py`` asserts it for the
reference). Failures surface as the original exception from
the iterator, mirroring ``Future.result()``.

The sink is a plain ``queue.Queue``: producers (serve threads, pumps)
never block, and a consumer iterating a stream whose gateway died waits
on ``timeout`` (default: forever, like ``Future.result()``).
"""
from __future__ import annotations

import dataclasses
import queue
from typing import Any, Optional

_PARTIAL, _FINAL, _ERROR = "partial", "final", "error"


@dataclasses.dataclass
class StreamChunk:
    """One streamed increment. ``kind`` is ``"partial"`` or ``"final"``;
    ``payload`` is a latents row at an exit boundary (flow) or one token
    id (decode) for partials, and the full ``Response``/``DecodeResponse``
    for the terminal chunk; ``meta`` records where the partial came from
    (flow: ``boundary``; decode: ``index``)."""

    kind: str
    payload: Any
    meta: dict = dataclasses.field(default_factory=dict)

    @property
    def final(self) -> bool:
        return self.kind == _FINAL


class StreamSink:
    """Producer side: the gateway pushes partials/final/error; never
    blocks. One sink per streamed entry, attached at submit."""

    __slots__ = ("_q",)

    def __init__(self) -> None:
        self._q: queue.Queue = queue.Queue()

    def partial(self, payload: Any, **meta: Any) -> None:
        self._q.put((_PARTIAL, payload, meta))

    def final(self, response: Any) -> None:
        self._q.put((_FINAL, response, None))

    def error(self, exc: BaseException) -> None:
        self._q.put((_ERROR, exc, None))


class ResponseStream:
    """Consumer side: iterate chunks until the terminal one (which carries
    the settled response); raises the settle exception like
    ``Future.result()`` would. ``result(timeout=)`` delegates to the
    underlying future for callers that only want the terminal value."""

    def __init__(self, future, sink: StreamSink,
                 timeout: Optional[float] = None):
        self.future = future
        self._sink = sink
        self._timeout = timeout
        self._done = False

    def __iter__(self):
        while not self._done:
            kind, payload, meta = self._sink._q.get(timeout=self._timeout)
            if kind == _ERROR:
                self._done = True
                raise payload
            if kind == _FINAL:
                self._done = True
                yield StreamChunk(_FINAL, payload)
                return
            yield StreamChunk(_PARTIAL, payload, meta or {})

    def chunks(self, timeout: Optional[float] = None) -> list[StreamChunk]:
        """Drain the whole stream (partials + terminal) into a list."""
        self._timeout = timeout if timeout is not None else self._timeout
        return list(self)

    def result(self, timeout: Optional[float] = None):
        return self.future.result(timeout)
