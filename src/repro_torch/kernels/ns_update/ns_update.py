"""CUDA NS update kernel (``csrc/ns_update.cu``), bound through ctypes.

    x_{i+1} = a * x0 + sum_j w_j U_j

Replaces the Pallas kernel ``repro.kernels.ns_update.ns_update`` and its
``ns_update_nd`` padding wrapper: any trailing shape works as is.
``ns_update_bwd`` is its backward (dU, dx0, da, dw) in one launch.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, dtensor

COUNTER = build.LaunchCounter("ns_update")
BWD_COUNTER = build.LaunchCounter("ns_update_bwd")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_N = 64
_BOUND = None


def bind(lib) -> tuple:
    """``lib`` (a build of ``csrc/ns_update.cu``) with the argument types of its
    ``ns_update_fwd``, ``ns_update_bwd`` and ``ns_update_bwd_max_blocks`` set:
    (lib, forward, backward)."""
    fn = lib.ns_update_fwd
    fn.argtypes = ([ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 4
                   + [ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
                      ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    bwd = lib.ns_update_bwd
    bwd.argtypes = ([ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 5
                    + [ctypes.c_longlong] + [ctypes.c_void_p] * 4
                    + [ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_void_p])
    bwd.restype = ctypes.c_int
    lib.ns_update_bwd_max_blocks.argtypes = [ctypes.c_int]
    lib.ns_update_bwd_max_blocks.restype = ctypes.c_int
    return lib, fn, bwd


def _entry():
    """The library and its bound entry points, looked up once."""
    global _BOUND
    if _BOUND is None:
        _BOUND = bind(build.load("ns_update"))
    return _BOUND


def _refuse(x0, u, a, w):
    """Raise the error that names what ``ns_update`` does not take."""
    if a.dtype != torch.float32 or w.dtype != torch.float32:
        raise TypeError(f"ns_update takes float32 a and w (ns_sample converts them "
                        f"once, before its loop), got {a.dtype} and {w.dtype}")
    if not (x0.is_cuda and u.is_cuda and a.is_cuda and w.is_cuda):
        raise ValueError("ns_update launches the CUDA kernel: every argument "
                         "must be a CUDA tensor (ops.fused_ns_update runs the "
                         "plain version on the CPU)")
    if len({x0.device, u.device, a.device, w.device}) != 1:
        raise ValueError("ns_update arguments lie on different devices")
    if x0.dtype not in _DTYPES or u.dtype != x0.dtype:
        raise TypeError(f"ns_update takes float32 or bfloat16 x0 and u of one "
                        f"dtype, got {x0.dtype} and {u.dtype}")
    n = u.shape[0]
    if u.shape[1:] != x0.shape or a.numel() != 1 or w.shape != (n,):
        raise ValueError(f"shapes: x0 {tuple(x0.shape)}, u {tuple(u.shape)}, "
                         f"a {tuple(a.shape)}, w {tuple(w.shape)}")
    if not 1 <= n <= _MAX_N:
        raise ValueError(f"ns_update takes 1..{_MAX_N} velocity rows, got {n}")
    raise ValueError("ns_update needs contiguous x0 and u")


def ns_update(x0: torch.Tensor, u: torch.Tensor, a: torch.Tensor,
              w: torch.Tensor) -> torch.Tensor:
    """x0: (B, ...) f32 or bf16; u: (n, *x0.shape), same dtype; a: f32 scalar;
    w: (n,) f32, any stride.

    All on one CUDA device, x0 and u contiguous. ``a`` and ``w`` stay on the
    device and the kernel reads them there, so the call never synchronises and
    launches nothing else. The checks run as one expression and the C entry
    point makes x0's card current if it is not, to keep the per-step host
    work small. Returns a new tensor of x0's shape and dtype.
    """
    if type(x0) is not torch.Tensor or type(u) is not torch.Tensor:
        dtensor.refuse("ns_update", x0, u, a, w)
    dev, n = x0.device, u.shape[0]
    if not (a.dtype == torch.float32 and w.dtype == torch.float32
            and dev.type == "cuda" and u.device == dev and a.device == dev
            and w.device == dev and x0.dtype in _DTYPES and u.dtype == x0.dtype
            and u.shape[1:] == x0.shape and a.numel() == 1 and w.shape == (n,)
            and 1 <= n <= _MAX_N and x0.is_contiguous() and u.is_contiguous()):
        _refuse(x0, u, a, w)
    out = torch.empty_like(x0)
    lib, fn, _ = _entry()
    err = fn(dev.index, _DTYPES[x0.dtype], x0.data_ptr(), u.data_ptr(), a.data_ptr(),
             w.data_ptr(), w.stride(0), out.data_ptr(), x0.numel(), n,
             torch._C._cuda_getCurrentRawStream(dev.index))  # as torch's compiled code reads it
    if err:
        build.check(lib, err, "ns_update")
    COUNTER.launches += 1
    return out


class _Workspace:
    """The backward's per-block partial sums and its arrival counter on one
    device (the kernel leaves the counter at 0). Made by the device's first
    eager call, outside any CUDA graph's pool: a captured program's warm-up
    is such a call, and a capture that would make it raises."""

    def __init__(self, lib, index: int):
        device = torch.device("cuda", index)
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        self.max_blocks = lib.ns_update_bwd_max_blocks(sms)
        self.partials = torch.empty(self.max_blocks * (_MAX_N + 1), dtype=torch.float32,
                                    device=device)
        self.counter = torch.zeros(1, dtype=torch.int32, device=device)


_WORKSPACES: dict[int, _Workspace] = {}


def ns_update_bwd(g: torch.Tensor, x0: torch.Tensor, u: torch.Tensor, a: torch.Tensor,
                  w: torch.Tensor, *, need_x0: bool = True):
    """Backward of ``ns_update``: (dx0 or None, du, da, dw) for the gradient
    ``g`` of its output.

    ``du = w_j g`` (u's shape and dtype), ``dx0 = a g`` (x0's dtype; skipped
    when ``need_x0`` is False), ``da = <x0, g>`` and ``dw_j = <u_j, g>`` in f32
    (a's and w's shapes). Takes what ``ns_update`` takes, plus ``g``: a
    contiguous tensor of x0's shape and dtype on the same device. One launch;
    the dot products are reduced across blocks in a fixed order through a
    workspace kept per device, so calls on one device must be ordered on one
    stream, as every path of the port is.
    """
    dtensor.refuse("ns_update_bwd", g, x0, u, a, w)
    dev, n = x0.device, u.shape[0]
    if not (a.dtype == torch.float32 and w.dtype == torch.float32
            and dev.type == "cuda" and u.device == dev and a.device == dev
            and w.device == dev and x0.dtype in _DTYPES and u.dtype == x0.dtype
            and u.shape[1:] == x0.shape and a.numel() == 1 and w.shape == (n,)
            and 1 <= n <= _MAX_N and x0.is_contiguous() and u.is_contiguous()):
        _refuse(x0, u, a, w)
    if g.device != dev or g.dtype != x0.dtype or g.shape != x0.shape or not g.is_contiguous():
        raise ValueError(f"ns_update_bwd: g must be a contiguous {x0.dtype} tensor of "
                         f"x0's shape {tuple(x0.shape)} on {dev}, got {g.dtype} "
                         f"{tuple(g.shape)} on {g.device}")
    lib, _, fn = _entry()
    index = dev.index
    ws = _WORKSPACES.get(index)
    if ws is None:
        with torch.cuda.device(index):
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError("ns_update_bwd: no workspace on this device before a "
                                   "CUDA graph captures the backward; run the captured "
                                   "function eagerly once first (its warm-up)")
        ws = _WORKSPACES[index] = _Workspace(lib, index)
    du = torch.empty_like(u)
    dx0 = torch.empty_like(x0) if need_x0 else None
    grads = torch.empty(n + 1, dtype=torch.float32, device=dev)
    err = fn(index, _DTYPES[x0.dtype], g.data_ptr(), x0.data_ptr(), u.data_ptr(),
             a.data_ptr(), w.data_ptr(), w.stride(0), du.data_ptr(),
             None if dx0 is None else dx0.data_ptr(), grads.data_ptr(),
             ws.partials.data_ptr(), ws.max_blocks, ws.counter.data_ptr(), x0.numel(), n,
             torch._C._cuda_getCurrentRawStream(index))
    if err:
        build.check(lib, err, "ns_update_bwd")
    BWD_COUNTER.launches += 1
    return dx0, du, grads[0].reshape(a.shape), grads[1:]
