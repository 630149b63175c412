"""CUDA NS update kernel (``csrc/ns_update.cu``), bound through ctypes.

    x_{i+1} = a * x0 + sum_j w_j U_j

Replaces the Pallas kernel ``repro.kernels.ns_update.ns_update`` and its
``ns_update_nd`` padding wrapper: any trailing shape works as is.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

COUNTER = build.LaunchCounter("ns_update")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_N = 64
_BOUND = None


def _entry():
    """The library and its bound ``ns_update_fwd``, looked up once."""
    global _BOUND
    if _BOUND is None:
        lib = build.load("ns_update")
        fn = lib.ns_update_fwd
        fn.argtypes = ([ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 4
                       + [ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
                          ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _BOUND = lib, fn
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
    dev, n = x0.device, u.shape[0]
    if not (a.dtype == torch.float32 and w.dtype == torch.float32
            and dev.type == "cuda" and u.device == dev and a.device == dev
            and w.device == dev and x0.dtype in _DTYPES and u.dtype == x0.dtype
            and u.shape[1:] == x0.shape and a.numel() == 1 and w.shape == (n,)
            and 1 <= n <= _MAX_N and x0.is_contiguous() and u.is_contiguous()):
        _refuse(x0, u, a, w)
    out = torch.empty_like(x0)
    lib, fn = _entry()
    err = fn(dev.index, _DTYPES[x0.dtype], x0.data_ptr(), u.data_ptr(), a.data_ptr(),
             w.data_ptr(), w.stride(0), out.data_ptr(), x0.numel(), n,
             torch._C._cuda_getCurrentRawStream(dev.index))  # as torch's compiled code reads it
    if err:
        build.check(lib, err, "ns_update")
    COUNTER.launches += 1
    return out
