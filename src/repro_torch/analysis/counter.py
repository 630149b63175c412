"""Per-rank flops, bytes, collectives and live memory of a traced step.

The port's twin of ``repro.analysis.hlo``, which reads them off XLA's
optimized HLO. Here a ``TorchDispatchMode`` watches the step run, usually on
fake tensors of a fake process group (``launch.dryrun``), and totals what
ONE rank computes:

  flops        matmul flops, 2 * prod(out) * contracted dims (``mm``,
               ``addmm``, ``bmm``, ``baddbmm``, ``mv``, ``dot``,
               ``convolution``), the MFU convention: elementwise work is
               ignored. A hand-written kernel reached on fake tensors adds
               the products it would run (``kernels.build.fake_launch``).
  bytes        operands + outputs of every op that moves data (views,
               allocations and waits move none). An eager step materialises
               every op, so this overstates the traffic of XLA's fusions,
               which count only their boundary tensors.
  collectives  output bytes and counts per kind ("all-gather", "all-reduce",
               "reduce-scatter", "all-to-all", ...), with ``<kind>_count``.
  peak_bytes   the most bytes that storages made during the step held at
               once; ``live_bytes`` those still held (the outputs).

Per rank: an op with a DTensor among its arguments is passed on
(``NotImplemented``) to DTensor's own dispatch, which runs the op on this
rank's local shards and inserts the collectives, and the mode counts those
local ops. Counting at the DTensor op would see global shapes. The ops that
DTensor's sharding propagation runs to learn an output's global shape (on
global-shape fake tensors, in the step's own fake mode when one is active)
are not the step's and are skipped: those run under a frame of DTensor's
``_propagate_tensor_meta*``; with ``fake_mode`` given, ops on another mode's
fake tensors are skipped too, and ops on meta tensors always are.
"""
from __future__ import annotations

import math
import sys
import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import build

_MATMUL = {"mm", "addmm", "bmm", "baddbmm", "mv", "dot", "convolution"}
_NO_TRAFFIC = {"empty", "empty_strided", "empty_like", "new_empty", "new_empty_strided",
               "wait_tensor", "device", "detach", "lift_fresh", "sym_size",
               "sym_stride", "sym_numel", "sym_storage_offset", "is_same_size"}
_COLLECTIVE_NS = ("_c10d_functional", "c10d_functional", "c10d")
_COLLECTIVE_KINDS = (("all_gather", "all-gather"), ("allgather", "all-gather"),
                     ("reduce_scatter", "reduce-scatter"), ("all_reduce", "all-reduce"),
                     ("allreduce", "all-reduce"), ("all_to_all", "all-to-all"),
                     ("alltoall", "all-to-all"), ("broadcast", "broadcast"),
                     ("send", "collective-permute"), ("recv", "collective-permute"))


def _in_shape_propagation(depth: int = 80) -> bool:
    """Whether the caller runs inside DTensor's output-shape propagation."""
    f = sys._getframe(2)
    while f is not None and depth:
        if f.f_code.co_name.startswith("_propagate_tensor_meta"):
            return True
        f, depth = f.f_back, depth - 1
    return False


def _tensors(tree) -> list[torch.Tensor]:
    """The tensors among an op's arguments or outputs (a tensor, or
    sequences and dicts of them, as aten's schemas nest them)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def matmul_flops(name: str, args: tuple, out) -> float:
    """2 * prod(out) * contracted extent for the matmul-like aten ops."""
    if name in ("mm", "bmm", "mv", "dot"):
        k = args[0].shape[-1]
    elif name in ("addmm", "baddbmm"):
        k = args[1].shape[-1]
    elif name == "convolution":         # w: (out, in / groups, *kernel)
        k = math.prod(args[1].shape[1:])
    else:
        return 0.0
    return 2.0 * out.numel() * k


def collective_kind(func) -> str | None:
    ns = func.namespace
    if ns not in _COLLECTIVE_NS:
        return None
    name = func.__name__.split(".")[0]
    for key, kind in _COLLECTIVE_KINDS:
        if key in name:
            return kind
    return None if name in ("wait_tensor", "wait") else name


class CostCounter(TorchDispatchMode):
    """``with CostCounter(fake_mode) as c: step()``; then ``c.result()``.

    ``fake_mode``: the ``FakeTensorMode`` the step's tensors belong to (None
    for real tensors). Only local ops count (see the module docstring)."""

    def __init__(self, fake_mode=None):
        super().__init__()
        self.fake_mode = fake_mode
        self.flops = 0.0
        self.bytes = 0.0
        self.collectives: dict = defaultdict(float)
        self.kernels: dict = defaultdict(int)
        self.live_bytes = 0
        self.peak_bytes = 0
        self._storages: dict[int, int] = {}

    # -- what counts ----------------------------------------------------------
    def _own(self, tensors) -> bool:
        from torch._subclasses.fake_tensor import FakeTensor

        for t in tensors:
            if t.device.type == "meta":
                return False
            if isinstance(t, FakeTensor) and t.fake_mode is not self.fake_mode:
                return False
        return True

    def _allocated(self, outs, ins) -> None:
        """Track the storages ``outs`` hold that no input shares and that
        are not tracked yet: new allocations, live until collected."""
        seen = {id(t.untyped_storage()) for t in ins}
        for t in outs:
            st = t.untyped_storage()
            key = id(st)
            if key in seen or key in self._storages:
                continue
            n = st.nbytes()
            self._storages[key] = n
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(st, self._freed, key)

    def _freed(self, key: int) -> None:
        self.live_bytes -= self._storages.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented            # DTensor runs it on the local shards
        out = func(*args, **kwargs)
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        if not self._own(ins + outs) or _in_shape_propagation():
            return out
        name = func.__name__.split(".")[0]
        if name in _MATMUL:
            self.flops += matmul_flops(name, args, outs[0])
        kind = collective_kind(func)
        if kind is not None:
            self.collectives[kind] += sum(nbytes(t) for t in outs)
            self.collectives[kind + "_count"] += 1
        if not (getattr(func, "is_view", False) or name in _NO_TRAFFIC):
            self.bytes += sum(nbytes(t) for t in ins) + sum(nbytes(t) for t in outs)
        if not getattr(func, "is_view", False):
            self._allocated(outs, ins)
        return out

    # -- hand-written kernels on fake tensors ---------------------------------
    def _fake_launch(self, name: str, flops: float, inputs, outputs) -> None:
        ins, outs = _tensors(inputs), _tensors(outputs)
        if not self._own(ins + outs):
            return
        self.kernels[name] += 1
        self.flops += flops
        self.bytes += sum(nbytes(t) for t in ins) + sum(nbytes(t) for t in outs)

    def __enter__(self):
        build.FAKE_LISTENERS.append(self._fake_launch)
        return super().__enter__()

    def __exit__(self, *exc):
        build.FAKE_LISTENERS.remove(self._fake_launch)
        return super().__exit__(*exc)

    def result(self) -> dict:
        """The reference analyzer's keys (``flops``, ``bytes``,
        ``collectives``) and the memory and kernel totals."""
        return {"flops": self.flops, "bytes": self.bytes,
                "collectives": dict(self.collectives),
                "peak_bytes": self.peak_bytes, "live_bytes": self.live_bytes,
                "kernels": dict(self.kernels)}
