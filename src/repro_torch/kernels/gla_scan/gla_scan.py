"""CUDA gated-linear-recurrence kernels (``csrc/gla_scan.cu`` and its backward,
``csrc/gla_scan_bwd.cu``), bound through ctypes.

    S_t = diag(exp(ld_t)) S_{t-1} + k_t v_t^T ;  o_t = q_t^T S_t (inclusive) or S_{t-1}

Replaces the Pallas kernel ``repro.kernels.gla_scan.gla_scan``: one block per
(batch row, head) walks its chunks in order with the f32 state in shared
memory. The C entry point picks one of two kernels by type and shape
(``kernel_for`` names it): bf16 q, k, v with dk and dv multiples of 16 up to
128 and a chunk of 16, 32 or 64 (every ported model's path) take the
tensor-core kernel, whose chunks are cut into 16-row sub-chunks with the
matrix products on ``mma.sync``; everything else (f32 q, k, v, other sizes)
takes the CUDA-core kernel. Unlike the Pallas kernel it takes any L (a
ragged last chunk is padded with zeros in the kernel, as ``gla_chunked``
pads it), an initial state, and one decay per head (ld's last dim 1, read
with a stride of 0).

``gla_scan_bwd`` computes the gradients (``ref.gla_chunked_bwd``'s closed
form): one block a (batch row, head) walks its chunks forwards from s0, then
in reverse carrying the state's gradient. Its C entry point picks one of two
kernels by the forward's rule (``bwd_kernel_for`` names it): the tensor-core
kernel (16-row sub-chunks, ``mma.sync`` products; the forward sweep leaves
dq's state term in the scratch) or the CUDA-core one (the forward sweep
leaves each chunk's starting state). q and k may be one group broadcast over
the heads ((B, L, 1, dk)): their gradients are then summed over the heads in
the library.

On fake tensors (``build.is_fake``: every tensor input a ``FakeTensor``, as
in the dry run, ``launch.dryrun``) both launchers allocate their outputs and
workspaces (the backward's by ``uses_mma``, the C library's rule copied)
as for a launch, report the chunked form's products to
``build.fake_launch``, and launch and build nothing.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

COUNTER = build.LaunchCounter("gla_scan")
BWD_COUNTER = build.LaunchCounter("gla_scan_bwd")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_SMEM_BYTES = 232448            # the H100's dynamic shared memory per block


def _lib():
    lib = build.load("gla_scan")
    fn = lib.gla_scan_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.gla_scan_smem_bytes.argtypes = [ctypes.c_int] * 5
        lib.gla_scan_smem_bytes.restype = ctypes.c_longlong
        lib.gla_scan_uses_mma.argtypes = [ctypes.c_int] * 4
        lib.gla_scan_uses_mma.restype = ctypes.c_int
    return lib


def uses_mma(dtype: torch.dtype, dk: int, dv: int, chunk: int) -> bool:
    """The C libraries' rule for the tensor-core kernels (``uses_mma`` in
    both sources), for fake tensors, where no library is loaded."""
    return (dtype == torch.bfloat16 and dk % 16 == 0 and dv % 16 == 0 and dk <= 128
            and dv <= 128 and chunk in (16, 32, 64))


def chunked_flops(B: int, L: int, H: int, dk: int, dv: int, chunk: int,
                  backward: bool = False) -> float:
    """The chunked form's products a (batch row, head): in each chunk of c
    rows the scores (c x c x dk), their product with v (c x c x dv), the
    state's read by q and its update (c x dk x dv each); the backward
    recomputes the scores and the states and forms dq, dk, dv and the
    state's gradient, c^2 (3 dk + 2 dv) + 5 c dk dv."""
    c = min(chunk, L)
    n = -(-L // c)
    per = (c * c * (3 * dk + 2 * dv) + 5 * c * dk * dv if backward
           else c * c * (dk + dv) + 2 * c * dk * dv)
    return 2.0 * B * H * n * per


def kernel_for(dtype: torch.dtype, L: int, dk: int, dv: int, chunk: int = 64) -> str:
    """Which kernel ``gla_scan`` launches for q, k, v of ``dtype`` at these
    sizes: "tensor-core" or "CUDA-core" (the C library's own rule)."""
    if dtype not in _DTYPES:
        raise TypeError(f"gla_scan takes float32 or bfloat16 q, k, v, got {dtype}")
    mma = _lib().gla_scan_uses_mma(_DTYPES[dtype], dk, dv, min(chunk, L))
    return "tensor-core" if mma else "CUDA-core"


def gla_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, ld: torch.Tensor,
             s0: Optional[torch.Tensor] = None, *, inclusive: bool = True,
             chunk: int = 64) -> tuple[torch.Tensor, torch.Tensor]:
    """q, k: (B, L, H, dk); ld: (B, L, H, dk) or (B, L, H, 1); v: (B, L, H, dv);
    s0: None or (B, H, dk, dv). Returns (o (B, L, H, dv) in v's dtype,
    final state (B, H, dk, dv) f32).

    CUDA tensors on one device. q, k and v share one dtype, f32 or bf16; ld is
    f32 or bf16 on its own; s0 is cast to a contiguous f32 tensor. Any
    strides: the kernel reads each input through its (b, l, h, d) strides.
    ``chunk`` is cut to L, as ``gla_chunked`` cuts it.
    """
    if not (q.is_cuda and k.is_cuda and v.is_cuda and ld.is_cuda):
        raise ValueError("gla_scan launches the CUDA kernel: q, k, v, ld must be "
                         "CUDA tensors (ops.gla runs the plain version on the CPU)")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"gla_scan takes float32 or bfloat16 q, k, v of one dtype, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if ld.dtype not in _DTYPES:
        raise TypeError(f"gla_scan takes a float32 or bfloat16 ld, got {ld.dtype}")
    if q.dim() != 4 or k.shape != q.shape or v.dim() != 4 or ld.dim() != 4:
        raise ValueError(f"shapes: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, ld {tuple(ld.shape)}")
    B, L, H, dk = q.shape
    dv = v.shape[-1]
    if tuple(v.shape[:3]) != (B, L, H) or tuple(ld.shape[:3]) != (B, L, H) \
            or ld.shape[3] not in (1, dk):
        raise ValueError(f"shapes: q {tuple(q.shape)}, v {tuple(v.shape)}, "
                         f"ld {tuple(ld.shape)}")
    if min(B, L, H, dk, dv) < 1 or B > 65535 or H > 2 ** 31 - 1 or chunk < 1:
        raise ValueError(f"unsupported extents B={B} L={L} H={H} dk={dk} dv={dv} "
                         f"chunk={chunk}")
    devices = {q.device, k.device, v.device, ld.device}
    if s0 is not None:
        if tuple(s0.shape) != (B, H, dk, dv):
            raise ValueError(f"s0 has shape {tuple(s0.shape)}, expected {(B, H, dk, dv)}")
        devices.add(s0.device)
        s0 = s0.to(torch.float32).contiguous()
    if len(devices) != 1:
        raise ValueError("gla_scan arguments lie on different devices")
    chunk = min(chunk, L)
    o = torch.empty((B, L, H, dv), dtype=v.dtype, device=q.device)
    state = torch.empty((B, H, dk, dv), dtype=torch.float32, device=q.device)
    if build.is_fake(q, k, v, ld, s0):
        build.fake_launch("gla_scan", chunked_flops(B, L, H, dk, dv, chunk),
                          (q, k, v, ld, s0), (o, state))
        return o, state
    lib = _lib()
    smem = lib.gla_scan_smem_bytes(_DTYPES[q.dtype], _DTYPES[ld.dtype], dk, dv, chunk)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"gla_scan at dk={dk}, dv={dv}, chunk={chunk} needs {smem} "
                         f"bytes of shared memory a block, over the {MAX_SMEM_BYTES} "
                         "the card gives")
    ld = ld.expand(B, L, H, dk)          # one decay per head: a stride of 0 on d
    strides = [s for t in (q, k, v, ld) for s in t.stride()]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.gla_scan_fwd(
            _DTYPES[q.dtype], _DTYPES[ld.dtype], int(inclusive), q.data_ptr(),
            k.data_ptr(), v.data_ptr(), ld.data_ptr(),
            None if s0 is None else s0.data_ptr(), o.data_ptr(), state.data_ptr(),
            B, L, H, dk, dv, chunk, (ctypes.c_longlong * 16)(*strides), stream)
    build.check(lib, err, "gla_scan")
    COUNTER.launches += 1
    return o, state


def _bwd_lib():
    lib = build.load("gla_scan_bwd")
    fn = lib.gla_scan_bwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] * 5 + [ctypes.c_void_p] * 15 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.gla_scan_bwd_smem_bytes.argtypes = [ctypes.c_int] * 4
        lib.gla_scan_bwd_smem_bytes.restype = ctypes.c_longlong
        lib.gla_scan_bwd_uses_mma.argtypes = [ctypes.c_int] * 4
        lib.gla_scan_bwd_uses_mma.restype = ctypes.c_int
    return lib


def bwd_kernel_for(dtype: torch.dtype, L: int, dk: int, dv: int, chunk: int = 64) -> str:
    """Which kernel ``gla_scan_bwd`` launches for q, k, v of ``dtype`` at these
    sizes: "tensor-core" or "CUDA-core" (the C library's own rule, the
    forward's)."""
    if dtype not in _DTYPES:
        raise TypeError(f"gla_scan_bwd takes float32 or bfloat16 q, k, v, got {dtype}")
    mma = _bwd_lib().gla_scan_bwd_uses_mma(_DTYPES[dtype], dk, dv, min(chunk, L))
    return "tensor-core" if mma else "CUDA-core"


def gla_scan_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, ld: torch.Tensor,
                 s0: Optional[torch.Tensor], do: torch.Tensor,
                 dS_final: Optional[torch.Tensor], *, inclusive: bool = True,
                 chunk: int = 64):
    """Gradients of ``gla_scan(q, k, v, ld, s0)`` for the output gradient
    ``do`` (B, L, H, dv) and the final state's ``dS_final`` (B, H, dk, dv) or
    None. Returns (dq, dk, dv, dld, ds0) in the shapes and dtypes of the
    inputs (ds0 None without s0), as ``ref.gla_chunked_bwd``.

    v: (B, L, H, dv); q, k: (B, L, H, dk), or (B, L, 1, dk) for one group
    broadcast over the heads (dq and dk summed over them); ld: (B, L, H, dk)
    or (B, L, H, 1). CUDA tensors on one device: q, k, v share one dtype, f32
    or bf16 (``do`` is cast to it), ld f32 or bf16; any strides. One call
    launches the kernel (and, for one group, the sum over the heads) and
    counts once.
    """
    if not all(t.is_cuda for t in (q, k, v, ld, do)):
        raise ValueError("gla_scan_bwd launches the CUDA kernel: q, k, v, ld, do must "
                         "be CUDA tensors (ops.gla differentiates the plain version "
                         "on the CPU)")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"gla_scan_bwd takes float32 or bfloat16 q, k, v of one dtype, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if ld.dtype not in _DTYPES:
        raise TypeError(f"gla_scan_bwd takes a float32 or bfloat16 ld, got {ld.dtype}")
    if q.dim() != 4 or k.shape != q.shape or v.dim() != 4 or ld.dim() != 4:
        raise ValueError(f"shapes: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, ld {tuple(ld.shape)}")
    B, L, H, dv = v.shape
    dk = q.shape[-1]
    if (tuple(q.shape[:2]) != (B, L) or q.shape[2] not in (1, H)
            or tuple(ld.shape[:3]) != (B, L, H) or ld.shape[3] not in (1, dk)
            or tuple(do.shape) != (B, L, H, dv)):
        raise ValueError(f"shapes: q {tuple(q.shape)}, v {tuple(v.shape)}, "
                         f"ld {tuple(ld.shape)}, do {tuple(do.shape)}")
    if min(B, L, H, dk, dv) < 1 or B > 65535 or chunk < 1:
        raise ValueError(f"unsupported extents B={B} L={L} H={H} dk={dk} dv={dv} "
                         f"chunk={chunk}")
    devices = {t.device for t in (q, k, v, ld, do)}
    state_shape = (B, H, dk, dv)
    for name, t in (("s0", s0), ("dS_final", dS_final)):
        if t is not None:
            if tuple(t.shape) != state_shape:
                raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {state_shape}")
            devices.add(t.device)
    if len(devices) != 1:
        raise ValueError("gla_scan_bwd arguments lie on different devices")
    chunk = min(chunk, L)
    fake = build.is_fake(q, k, v, ld, s0, do, dS_final)
    lib = None if fake else _bwd_lib()
    if not fake:
        smem = lib.gla_scan_bwd_smem_bytes(_DTYPES[q.dtype], dk, dv, chunk)
        if smem > MAX_SMEM_BYTES:
            raise ValueError(f"gla_scan_bwd at dk={dk}, dv={dv}, chunk={chunk} needs "
                             f"{smem} bytes of shared memory a block, over the "
                             f"{MAX_SMEM_BYTES} the card gives")
    group = q.shape[2] != H
    s0f = None if s0 is None else s0.to(torch.float32).contiguous()
    dSf = None if dS_final is None else dS_final.to(torch.float32).contiguous()
    do = do.to(v.dtype)
    qx, kx = q.expand(B, L, H, dk), k.expand(B, L, H, dk)
    ldx = ld.expand(B, L, H, dk)         # one decay a head: a stride of 0 on d
    dev = q.device
    n_chunks = -(-L // chunk)
    # the tensor-core kernel's forward sweep leaves dq's state term (c rows of
    # dk a chunk), the CUDA-core one's each chunk's starting state (dk x dv)
    mma = (uses_mma(q.dtype, dk, dv, chunk) if fake
           else lib.gla_scan_bwd_uses_mma(_DTYPES[q.dtype], dk, dv, chunk))
    per_chunk = (chunk if mma else dv) * dk
    scratch = torch.empty((B, H, n_chunks, per_chunk), dtype=torch.float32, device=dev)
    dq = torch.empty(q.shape, dtype=q.dtype, device=dev)
    dk_ = torch.empty(k.shape, dtype=k.dtype, device=dev)
    dv_ = torch.empty(v.shape, dtype=v.dtype, device=dev)
    dld = torch.empty(ld.shape, dtype=ld.dtype, device=dev)
    ds0 = None if s0 is None else torch.empty(state_shape, dtype=torch.float32, device=dev)
    ws = (torch.empty((2, B, L, H, dk), dtype=torch.float32, device=dev) if group
          else None)
    if fake:
        build.fake_launch("gla_scan_bwd", chunked_flops(B, L, H, dk, dv, chunk, True),
                          (q, k, v, ld, s0f, do, dSf),
                          (scratch, dq, dk_, dv_, dld, ds0, ws))
        return dq, dk_, dv_, dld, None if ds0 is None else ds0.to(s0.dtype)
    strides = [st for t in (qx, kx, v, ldx, do) for st in t.stride()]
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.gla_scan_bwd(
            _DTYPES[q.dtype], _DTYPES[ld.dtype], int(inclusive), int(ld.shape[3] != dk),
            int(group), qx.data_ptr(), kx.data_ptr(), v.data_ptr(), ldx.data_ptr(),
            do.data_ptr(), ptr(s0f), ptr(dSf), scratch.data_ptr(), dq.data_ptr(),
            dk_.data_ptr(), None if ws is None else ws[0].data_ptr(),
            None if ws is None else ws[1].data_ptr(), dv_.data_ptr(), dld.data_ptr(),
            ptr(ds0), B, L, H, dk, dv, chunk, (ctypes.c_longlong * 20)(*strides), stream)
    build.check(lib, err, "gla_scan_bwd")
    BWD_COUNTER.launches += 1
    return dq, dk_, dv_, dld, None if ds0 is None else ds0.to(s0.dtype)
