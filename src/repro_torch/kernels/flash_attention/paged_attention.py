"""CUDA paged decode attention (``csrc/paged_attention.cu``), bound through ctypes.

Replaces the Pallas kernel ``repro.kernels.flash_attention.paged_attention``:
one-token GQA attention of each row over its own pages of a shared KV pool,
resolved through the row's block table, up to the row's length.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

COUNTER = build.LaunchCounter("paged_attention")
HEAD_DIMS = (32, 64, 80, 128)
MAX_GROUP = 8                 # query heads per KV head the kernel holds in registers
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib():
    lib = build.load("paged_attention")
    fn = lib.paged_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 6
                       + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                    block_table: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """q: (B, KV, G, hd); k_pages, v_pages: (num_pages, page_size, KV, hd);
    block_table: (B, nb) int32 page ids; lengths: (B,) int32 valid positions
    per row. Returns (B, KV, G, hd) in q's dtype.

    CUDA tensors on one device, all contiguous (a per-layer view ``pool[l]``
    of the model's (L, num_pages, page_size, KV, hd) cache is). q and the
    pools each take f32 or bf16; hd in ``HEAD_DIMS``; G <= ``MAX_GROUP``. Page
    ids must lie in [0, num_pages): the caller's page allocator guarantees
    it, and checking would cost a device-to-host copy per call.
    """
    args = (q, k_pages, v_pages, block_table, lengths)
    if not all(t.is_cuda for t in args):
        raise ValueError("paged_attention launches the CUDA kernel: every argument "
                         "must be a CUDA tensor (ops.paged_attend runs the plain "
                         "version on the CPU)")
    if len({t.device for t in args}) != 1:
        raise ValueError("paged_attention arguments lie on different devices")
    if q.dtype not in _DTYPES or k_pages.dtype not in _DTYPES or v_pages.dtype != k_pages.dtype:
        raise TypeError(f"paged_attention takes f32 or bf16 q and f32 or bf16 pages "
                        f"(k and v alike), got {q.dtype}, {k_pages.dtype}, {v_pages.dtype}")
    if block_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError(f"block_table and lengths must be int32, got "
                        f"{block_table.dtype} and {lengths.dtype}")
    if q.dim() != 4 or k_pages.dim() != 4 or v_pages.shape != k_pages.shape:
        raise ValueError(f"shapes: q {tuple(q.shape)}, k_pages {tuple(k_pages.shape)}, "
                         f"v_pages {tuple(v_pages.shape)}")
    B, KV, G, hd = q.shape
    _, ps, kv_p, hd_p = k_pages.shape
    if (kv_p, hd_p) != (KV, hd) or block_table.dim() != 2 or block_table.shape[0] != B \
            or tuple(lengths.shape) != (B,):
        raise ValueError(f"shapes: q {tuple(q.shape)}, k_pages {tuple(k_pages.shape)}, "
                         f"block_table {tuple(block_table.shape)}, "
                         f"lengths {tuple(lengths.shape)}")
    nb = block_table.shape[1]
    if hd not in HEAD_DIMS:
        raise ValueError(f"paged_attention is built for head dims {HEAD_DIMS}, got {hd}")
    if not (1 <= G <= MAX_GROUP and 1 <= B <= 65535 and nb >= 1 and ps >= 1):
        raise ValueError(f"unsupported extents B={B} KV={KV} G={G} page_size={ps} nb={nb}")
    if not all(t.is_contiguous() for t in args):
        raise ValueError("paged_attention needs contiguous q, pools, block_table, lengths")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("paged_attention reads the pools in 16-byte loads: their data "
                         "must be 16-byte aligned")
    out = torch.empty_like(q)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.paged_attention_fwd(
            _DTYPES[q.dtype], _DTYPES[k_pages.dtype], hd, q.data_ptr(),
            k_pages.data_ptr(), v_pages.data_ptr(), block_table.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), B, KV, G, ps, nb, hd ** -0.5, stream)
    build.check(lib, err, "paged_attention")
    COUNTER.launches += 1
    return out
