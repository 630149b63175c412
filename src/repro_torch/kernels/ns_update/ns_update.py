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


def _lib():
    lib = build.load("ns_update")
    fn = lib.ns_update_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def ns_update(x0: torch.Tensor, u: torch.Tensor, a: torch.Tensor,
              w: torch.Tensor) -> torch.Tensor:
    """x0: (B, ...) f32 or bf16; u: (n, *x0.shape), same dtype; a: scalar; w: (n,).

    All on one CUDA device, x0 and u contiguous. ``a`` and ``w`` stay on the
    device: the (n+1,) f32 coefficient vector is built there, so the call
    never synchronises. Returns a new tensor of x0's shape and dtype.
    """
    if not (x0.is_cuda and u.is_cuda and a.is_cuda and w.is_cuda):
        raise ValueError("ns_update launches the CUDA kernel: every argument "
                         "must be a CUDA tensor (ops.fused_ns_update runs the "
                         "plain version on the CPU)")
    if x0.dtype not in _DTYPES or u.dtype != x0.dtype:
        raise TypeError(f"ns_update takes float32 or bfloat16 x0 and u of one "
                        f"dtype, got {x0.dtype} and {u.dtype}")
    n = u.shape[0]
    if tuple(u.shape[1:]) != tuple(x0.shape) or a.numel() != 1 or w.shape != (n,):
        raise ValueError(f"shapes: x0 {tuple(x0.shape)}, u {tuple(u.shape)}, "
                         f"a {tuple(a.shape)}, w {tuple(w.shape)}")
    if not 1 <= n <= _MAX_N:
        raise ValueError(f"ns_update takes 1..{_MAX_N} velocity rows, got {n}")
    if not (x0.is_contiguous() and u.is_contiguous()):
        raise ValueError("ns_update needs contiguous x0 and u")
    if len({x0.device, u.device, a.device, w.device}) != 1:
        raise ValueError("ns_update arguments lie on different devices")
    coeff = torch.cat([a.reshape(1), w]).to(torch.float32)
    out = torch.empty_like(x0)
    lib = _lib()
    with torch.cuda.device(x0.device):
        stream = torch.cuda.current_stream(x0.device).cuda_stream
        err = lib.ns_update_fwd(_DTYPES[x0.dtype], x0.data_ptr(), u.data_ptr(),
                                coeff.data_ptr(), out.data_ptr(), x0.numel(), n,
                                stream)
    build.check(lib, err, "ns_update")
    COUNTER.launches += 1
    return out
