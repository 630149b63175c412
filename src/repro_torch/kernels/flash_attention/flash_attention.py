"""CUDA flash attention kernel (``csrc/flash_attention.cu``), bound through ctypes.

Replaces the Pallas kernel ``repro.kernels.flash_attention.flash_attention``:
blocked online-softmax GQA attention, causal or not, for any sequence length
(the Pallas kernel needed L to be a multiple of its block).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

COUNTER = build.LaunchCounter("flash_attention")
HEAD_DIMS = (64, 80, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib():
    lib = build.load("flash_attention")
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 4
                       + [ctypes.c_int] * 5
                       + [ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q: (B, H, Lq, hd); k, v: (B, KV, Lk, hd); H % KV == 0. Returns q-shaped.

    CUDA tensors of one dtype, hd in ``HEAD_DIMS``, unit stride on hd; other
    strides are free, so transposed views of the model's (B, L, H, hd) layout
    pass without copies. bf16 runs on the tensor cores and needs 16-byte
    aligned data and strides that are multiples of 8; f32 runs on the CUDA
    cores. The output is a (B, H, Lq, hd) view of a (B, Lq, H, hd) buffer,
    the model's layout.
    """
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_attention launches the CUDA kernel: q, k, v "
                         "must be CUDA tensors (ops.attend runs the plain "
                         "version on the CPU)")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q, k, v of "
                        f"one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"shapes: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    B, H, Lq, hd = q.shape
    KV, Lk = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or H % KV:
        raise ValueError(f"shapes: q {tuple(q.shape)}, k {tuple(k.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention is built for head dims {HEAD_DIMS}, "
                         f"got {hd}")
    if min(Lq, Lk) < 1 or max(B, H) > 65535:
        raise ValueError(f"unsupported extents B={B} H={H} Lq={Lq} Lk={Lk}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("flash_attention needs unit stride on the head dim")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError("flash_attention arguments lie on different devices")
    o = torch.empty((B, Lq, H, hd), dtype=q.dtype, device=q.device).transpose(1, 2)
    strides = [s for t in (q, k, v, o) for s in t.stride()[:3]]
    if q.dtype == torch.bfloat16 and (any(s % 8 for s in strides) or any(
            t.data_ptr() % 16 for t in (q, k, v))):
        raise ValueError("bf16 flash_attention needs 16-byte aligned q, k, v "
                         "and strides that are multiples of 8")
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_fwd(
            _DTYPES[q.dtype], hd, int(causal), q.data_ptr(), k.data_ptr(),
            v.data_ptr(), o.data_ptr(), B, H, KV, Lq, Lk,
            (ctypes.c_longlong * 12)(*strides),
            hd ** -0.5, stream)
    build.check(lib, err, "flash_attention")
    COUNTER.launches += 1
    return o
