"""CUDA flash attention kernel (``csrc/flash_attention.cu``), bound through ctypes.

Replaces the Pallas kernel ``repro.kernels.flash_attention.flash_attention``:
blocked online-softmax GQA attention, causal or not, for any sequence length
(the Pallas kernel needed L to be a multiple of its block). Under grad the
forward also returns each query row's log-sum-exp, and ``flash_attention_bwd``
(``csrc/flash_attention_bwd.cu``) computes dq, dk and dv from it.

On fake tensors (``build.is_fake``: every tensor input a ``FakeTensor``, as
in the dry run, ``launch.dryrun``) both launchers allocate their outputs and
workspaces as for a launch, report the products to ``build.fake_launch``,
and launch and build nothing.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, dtensor

COUNTER = build.LaunchCounter("flash_attention")
BWD_COUNTER = build.LaunchCounter("flash_attention_bwd")
HEAD_DIMS = (64, 80, 128)     # the forward's, with or without the lse, and the backward's
BWD_QUERY_TILE = 128          # bf16 dq pass: query rows a block (the row workspace's padding)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib():
    lib = build.load("flash_attention")
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 5
                       + [ctypes.c_int] * 5
                       + [ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _bwd_lib():
    lib = build.load("flash_attention_bwd")
    fn = lib.flash_attention_bwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] * 4 + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def score_pairs(Lq: int, Lk: int, causal: bool) -> int:
    """The (query, key) pairs the kernel scores: all of them, or under the
    causal mask (key j <= query i) those on or below the diagonal."""
    if not causal:
        return Lq * Lk
    n = min(Lq, Lk)
    return n * (n + 1) // 2 + (Lq - n) * Lk


def _check_inputs(what: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """The checks the forward and the backward share."""
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError(f"{what} launches the CUDA kernel: q, k, v must be CUDA "
                         "tensors (ops.attend runs the plain version on the CPU)")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{what} takes float32 or bfloat16 q, k, v of one dtype, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"shapes: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    B, H, Lq, hd = q.shape
    KV, Lk = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or H % KV:
        raise ValueError(f"shapes: q {tuple(q.shape)}, k {tuple(k.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"{what} is built for head dims {HEAD_DIMS}, got {hd}")
    if min(Lq, Lk) < 1 or max(B, H) > 65535:
        raise ValueError(f"unsupported extents B={B} H={H} Lq={Lq} Lk={Lk}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError(f"{what} needs unit stride on the head dim")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError(f"{what} arguments lie on different devices")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, return_lse: bool = False):
    """q: (B, H, Lq, hd); k, v: (B, KV, Lk, hd); H % KV == 0. Returns q-shaped
    output, and with ``return_lse`` also each query row's natural log-sum-exp
    of the scaled scores, (B, H, Lq) f32, which the backward needs.

    CUDA tensors of one dtype, hd in ``HEAD_DIMS``, unit stride on hd; other
    strides are free, so transposed views of the model's (B, L, H, hd) layout
    pass without copies. bf16 runs on the tensor cores (TMA loads, wgmma) and
    needs 16-byte aligned data and strides that are multiples of 8, as TMA's
    tensor maps do; f32 runs on the CUDA cores. The output is a (B, H, Lq, hd) view of a (B, Lq, H, hd) buffer,
    the model's layout.
    """
    if not type(q) is type(k) is type(v) is torch.Tensor:
        dtensor.refuse("flash_attention", q, k, v)
    _check_inputs("flash_attention", q, k, v)
    B, H, Lq, hd = q.shape
    KV, Lk = k.shape[1], k.shape[2]
    o = torch.empty((B, Lq, H, hd), dtype=q.dtype, device=q.device).transpose(1, 2)
    lse = (torch.empty((B, H, Lq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if build.is_fake(q, k, v):
        build.fake_launch("flash_attention", 2 * 2 * B * H * hd * score_pairs(Lq, Lk, causal),
                          (q, k, v), (o, lse))
        return (o, lse) if return_lse else o
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
            v.data_ptr(), o.data_ptr(), None if lse is None else lse.data_ptr(),
            B, H, KV, Lq, Lk, (ctypes.c_longlong * 12)(*strides),
            hd ** -0.5, stream)
    build.check(lib, err, "flash_attention")
    COUNTER.launches += 1
    return (o, lse) if return_lse else o


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                        causal: bool = True, dkdv: bool = True):
    """Backward of ``flash_attention``: (dq, dk, dv) for the output gradient
    ``do``, from the forward's output ``o`` and ``lse``.

    q, o, do: (B, H, Lq, hd); k, v: (B, KV, Lk, hd); lse: (B, H, Lq) f32,
    contiguous. CUDA tensors of one dtype (f32 or bf16), hd in
    ``HEAD_DIMS``, unit stride on hd, other strides free: bf16 runs on the
    tensor cores (TMA, wgmma) and needs the forward's alignment for q, k, v
    and o (``do`` is made contiguous if it lacks it); f32 runs on the CUDA
    cores. dq, dk and dv are returned in q's and k's dtype as
    (B, heads, L, hd) views of (B, L, heads, hd) buffers, the model's
    layout. One call launches the kernels' two passes (dq with D =
    rowsum(dO * O), then dk and dv) and counts once; with ``dkdv=False``
    it runs the dq pass alone and returns None for dk and dv.
    """
    dtensor.refuse("flash_attention_bwd", q, k, v, o, lse, do)
    _check_inputs("flash_attention_bwd", q, k, v)
    B, H, Lq, hd = q.shape
    KV, Lk = k.shape[1], k.shape[2]
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device \
                or t.stride(3) != 1:
            raise ValueError(f"flash_attention_bwd: {name} must be like q "
                             f"{tuple(q.shape)} {q.dtype} with unit stride on hd, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if (lse.shape != (B, H, Lq) or lse.dtype != torch.float32 or lse.device != q.device
            or not lse.is_contiguous()):
        raise ValueError(f"flash_attention_bwd: lse must be a contiguous (B, H, Lq) "
                         f"float32 tensor, got {tuple(lse.shape)} {lse.dtype}")
    dq = torch.empty((B, Lq, H, hd), dtype=q.dtype, device=q.device).transpose(1, 2)
    dk, dv = ((torch.empty((B, Lk, KV, hd), dtype=q.dtype, device=q.device).transpose(1, 2)
               for _ in range(2)) if dkdv else (None, None))
    # each row's lse and D, padded to whole dq tiles
    lpad = -(-Lq // BWD_QUERY_TILE) * BWD_QUERY_TILE
    rows = torch.empty(B * H * 2 * lpad, dtype=torch.float32, device=q.device)
    if build.is_fake(q, k, v, o, lse, do):
        # the dq pass's three products, and the dk/dv pass's four
        products = 7 if dkdv else 3
        build.fake_launch("flash_attention_bwd",
                          products * 2 * B * H * hd * score_pairs(Lq, Lk, causal),
                          (q, k, v, o, lse, do), (dq, dk, dv, rows))
        return dq, dk, dv
    if q.dtype == torch.bfloat16:
        # the tensor-core path reads rows by TMA: the forward's alignment rule
        # for q, k, v, o; the incoming gradient is made contiguous if needed
        if any(s % 8 for t in (q, k, v, o) for s in t.stride()[:3]) or any(
                t.data_ptr() % 16 for t in (q, k, v, o)):
            raise ValueError("bf16 flash_attention_bwd needs 16-byte aligned q, k, v, o "
                             "and strides that are multiples of 8")
        if any(s % 8 for s in do.stride()[:3]) or do.data_ptr() % 16:
            do = do.contiguous()
    strides = [s for t in (q, k, v, o, do, dq) for s in t.stride()[:3]]
    strides += [s for t in (dk, dv) for s in (t.stride()[:3] if dkdv else (0, 0, 0))]
    lib = _bwd_lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_bwd(
            _DTYPES[q.dtype], hd, int(causal), int(dkdv), q.data_ptr(), k.data_ptr(),
            v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(), dq.data_ptr(),
            dk.data_ptr() if dkdv else None, dv.data_ptr() if dkdv else None,
            rows.data_ptr(), B, H, KV, Lq, Lk,
            (ctypes.c_longlong * 24)(*strides), hd ** -0.5, stream)
    build.check(lib, err, "flash_attention_bwd")
    BWD_COUNTER.launches += 1
    return dq, dk, dv
