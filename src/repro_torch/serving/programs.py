"""The serving engines' compiled-program cache: CUDA graphs keyed by shape.

The reference compiles every serving program once with ``jax.jit`` and keeps
it in a dict (``FlowSampler._per_budget``, ``AnytimeFlowSampler._all`` and
``_extends``, ``DecodeEngine._step_slots`` and ``_prefill_fns``, ...). The
port's counterpart is ``ProgramCache``: on the card, the first call of a key
runs the engine's function on a side stream (the warm-up PyTorch's graph
docs ask for; its result is that call's result) and then captures it into
one ``torch.cuda.CUDAGraph``; every later call of the key copies its inputs
into the program's static buffers, replays the graph and returns copies of
the static outputs, so a returned tensor is never overwritten by a later
replay (gateways keep responses across dispatches). A capture that fails
raises; nothing falls back to eager on the card.

A key holds what ``jax.jit`` retraces on: the caller's static part (budget,
leg, column count, conditioning present, ``cfg_scale``) plus, added here,
the shape, dtype and device of every input and the ``data_ptr()``, shape
and dtype of every state tensor the function updates in place (the graph
holds those by address). Tensors the function only reads and the caller
never replaces (weights, solver coefficients) are baked in by address.

``disabled()`` is the counterpart of ``jax.disable_jit()``: inside it every
cache runs its function eagerly. On the CPU the engines always run eagerly:
the reference's jit compiles there too, but a CPU has no graph to capture.

Launch counts: a capture launches nothing, so the ``LaunchCounter``s read
the same after it as before; a replay adds the launches its program recorded
at capture. The counts therefore equal an eager run's.

Sound use, which every engine of the port keeps:
- one replay at a time on a device: the paged-attention kernel's arrival
  counters (and the ``ns_update`` backward's) are left at 0 by the kernel
  and shared by every launch on the device. Engines replay on the caller's
  current stream, and every gateway dispatches under one lock of the
  process (``gateway.EXEC_LOCK``), a fleet's hosts included;
- the programs of a device share one memory pool, which is safe because
  replays never overlap and each replay's outputs are copied out before the
  next replay can write the pool;
- captures take ``capture_error_mode="thread_local"``: a host sync or a
  pageable copy in the captured code raises in the capturing thread, while a
  client thread that touches the card (a submit, a metrics read) neither
  breaks the capture nor is broken by it. No other thread launches work
  during a capture: the gateways capture inside their dispatch lock, and one
  lock here keeps captures one at a time in the process.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Callable, Optional

import torch

from repro_torch.kernels import build

_DISABLED = 0
_LOCK = threading.RLock()          # one capture at a time in the process
_STREAMS: dict[int, torch.cuda.Stream] = {}
_POOLS: dict[int, Any] = {}
# Tests only: a CPU stand-in for torch.cuda.CUDAGraph (``tests/test_torch_programs.py``).
# Called with no argument, it returns an object with ``capture(run, state)``,
# which must leave ``state`` as it found it and return ``run()``'s outputs,
# and ``replay()``, which recomputes them into those same output tensors.
_graph_double: Optional[Callable[[], Any]] = None


@contextlib.contextmanager
def disabled():
    """Run every engine eagerly inside the block (``jax.disable_jit()``)."""
    global _DISABLED
    with _LOCK:
        _DISABLED += 1
    try:
        yield
    finally:
        with _LOCK:
            _DISABLED -= 1


def _tensor_key(x) -> tuple:
    if x is None:
        return (None,)
    # a DTensor's layout is part of its key, as a sharding is of jit's
    return (tuple(x.shape), x.dtype, x.device, getattr(x, "placements", None))


def _address(x) -> int:
    """Where a state tensor lies: a DTensor's is its local shard's."""
    if type(x) is not torch.Tensor and hasattr(x, "to_local"):
        x = x.to_local()
    return x.data_ptr()


def _tree_map(fn, tree):
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return type(tree)(_tree_map(fn, v) for v in tree)


def _side_stream(index: int) -> torch.cuda.Stream:
    stream = _STREAMS.get(index)
    if stream is None:
        stream = _STREAMS[index] = torch.cuda.Stream(torch.device("cuda", index))
    return stream


def _pool(index: int):
    pool = _POOLS.get(index)
    if pool is None:
        pool = _POOLS[index] = torch.cuda.graph_pool_handle()
    return pool


class Program:
    """One captured program: static inputs, the graph, static outputs, and
    the launches it recorded per ``LaunchCounter``."""

    def __init__(self, graph, static_in: tuple, static_out, launches: dict,
                 capture_ms: float):
        self.graph = graph
        self.static_in = static_in
        self.static_out = static_out
        self.launches = launches
        self.capture_ms = capture_ms
        self.replays = 0

    def __call__(self, inputs: tuple):
        for buf, x in zip(self.static_in, inputs):
            if buf is not None:
                buf.copy_(x)
        self.graph.replay()
        for counter, n in self.launches.items():
            counter.launches += n
        self.replays += 1
        return _tree_map(torch.Tensor.clone, self.static_out)


def release_if_short(device: torch.device) -> bool:
    """Hand the allocator's cached free blocks back to the device when they
    exceed what the device has free. A capture allocates its working set
    from the graphs' pool, which cannot reuse the blocks the warm-up freed:
    where the working set is most of the card (backbone training), it
    cannot be held twice. True when it released them."""
    free, _ = torch.cuda.mem_get_info(device)
    if torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device) <= free:
        return False
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    return True


class ProgramCache:
    """Key -> captured ``Program`` for one engine on one device (module
    docstring). ``cache(key, fn, inputs, state)`` returns ``fn(*inputs)``:
    eagerly on the CPU or under ``disabled()``, else through the program of
    the full key (captured on the first call)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.programs: dict[tuple, Program] = {}
        self.last: Optional[Program] = None     # the program of the latest call

    def __len__(self) -> int:
        return len(self.programs)

    @property
    def active(self) -> bool:
        """True when calls go through captured programs."""
        return _DISABLED == 0 and (self.device.type == "cuda" or _graph_double is not None)

    @property
    def replays(self) -> int:
        return sum(p.replays for p in self.programs.values())

    @property
    def capture_ms(self) -> float:
        return sum(p.capture_ms for p in self.programs.values())

    def stats(self) -> dict:
        """Captured programs, replays and the summed capture ms."""
        return {"programs": len(self.programs), "replays": self.replays,
                "capture_ms": self.capture_ms}

    def __call__(self, key: tuple, fn: Callable, inputs: tuple = (), state: tuple = ()):
        """``fn(*inputs)``: ``inputs`` are tensors (or None) copied into the
        program's static buffers at every call; ``state`` the tensors ``fn``
        updates in place (read and written at their addresses, which the key
        holds). ``fn`` returns a tensor, a tuple, list or dict of tensors, or
        None."""
        if not self.active:
            return fn(*inputs)
        full = (key, tuple(_tensor_key(x) for x in inputs),
                tuple((_address(s),) + _tensor_key(s) for s in state))
        program = self.programs.get(full)
        if program is not None:
            self.last = program
            return program(inputs)
        with _LOCK:
            out, self.last = self._capture(fn, inputs, state)
            self.programs[full] = self.last
        return out

    def _capture(self, fn, inputs, state):
        static_in = tuple(None if x is None else x.clone() for x in inputs)
        if self.device.type != "cuda":
            out = fn(*inputs)
            before = {c: c.launches for c in build.COUNTERS}
            t0 = time.perf_counter()
            graph = _graph_double()
            static_out = graph.capture(lambda: fn(*static_in), state)
        else:
            index = self.device.index if self.device.index is not None \
                else torch.cuda.current_device()
            stream, current = _side_stream(index), torch.cuda.current_stream(self.device)
            stream.wait_stream(current)
            with torch.cuda.stream(stream):
                out = fn(*inputs)                # the warm-up is this call
            current.wait_stream(stream)
            release_if_short(self.device)
            before = {c: c.launches for c in build.COUNTERS}
            t0 = time.perf_counter()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=_pool(index), stream=stream,
                                  capture_error_mode="thread_local"):
                static_out = fn(*static_in)
        capture_ms = (time.perf_counter() - t0) * 1e3
        launches = {}
        for c in build.COUNTERS:             # counters made during the capture start at 0
            n = c.launches - before.get(c, 0)
            c.launches -= n                  # a capture launches nothing
            if n:
                launches[c] = n
        return out, Program(graph, static_in, static_out, launches, capture_ms)
