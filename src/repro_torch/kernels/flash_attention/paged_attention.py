"""CUDA paged decode attention (``csrc/paged_attention.cu``), bound through ctypes.

Replaces the Pallas kernel ``repro.kernels.flash_attention.paged_attention``:
one-token GQA attention of each row over its own pages of a shared KV pool,
resolved through the row's block table, up to the row's length. The kernel
cuts each row's pages into splits (``split_plan``), one block a (split, KV
head, row), and merges the splits in the same launch through a workspace and
per-(row, head) arrival counters that this module allocates once per device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, dtensor

COUNTER = build.LaunchCounter("paged_attention")
HEAD_DIMS = (32, 64, 80, 128)
MAX_GROUP = 16                # query heads per KV head the kernel takes (qwen3-moe-235b-a22b: 16)
BLOCKS_PER_SM = 4             # blocks an SM the plan aims at (the CUDA-core kernel's minimum)
TILE = 16                     # positions a stage of the kernel's ring holds
MAX_GRID_Y = 65535            # CUDA's limit on gridDim.y, which carries the rows
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def split_plan(B: int, KV: int, nb: int, ps: int, num_sms: int) -> tuple[int, int, tuple]:
    """(pages per split, splits per row, grid) for B rows of nb pages of ps
    positions and KV heads, from the shapes alone (lengths stay on the card).

    Aims at ``BLOCKS_PER_SM`` blocks an SM: as many splits as that allows,
    at most one a page, and at least one tile of positions a split. Split s
    covers pages [s * pps, min((s + 1) * pps, nb)); the grid is
    (splits * KV, B), and a block whose split starts past its row's length
    exits at once.
    """
    splits = max(1, min(nb, BLOCKS_PER_SM * num_sms // (B * KV)))
    pps = min(nb, max(-(-nb // splits), -(-TILE // ps)))
    splits = -(-nb // pps)
    return pps, splits, (splits * KV, B)


class _Device:
    """What the launches on one device keep: its SM count, the merge's f32
    workspace and int32 arrival counters (grown when a call needs more; the
    kernel leaves the counters at 0), and the plan of each shape seen.

    A grown workspace does not free the one it replaces: a CUDA graph
    captured earlier (``serving.programs``) holds the old pointers and reads
    them at every replay, so every buffer a plan ever handed out lives as
    long as this object."""

    def __init__(self, index: int):
        device = torch.device("cuda", index)
        self.num_sms = torch.cuda.get_device_properties(device).multi_processor_count
        self.workspace = torch.empty(0, dtype=torch.float32, device=device)
        self.counters = torch.zeros(0, dtype=torch.int32, device=device)
        self.retired: list[tuple[torch.Tensor, torch.Tensor]] = []
        self.plans: dict[tuple, tuple] = {}

    def plan(self, B: int, KV: int, G: int, hd: int, nb: int, ps: int) -> tuple:
        """(pages per split, workspace pointer, counters pointer) for a shape;
        the pointers are None where one split covers the row."""
        key = (B, KV, G, hd, nb, ps)
        got = self.plans.get(key)
        if got is None:
            pps, splits, _ = split_plan(B, KV, nb, ps, self.num_sms)
            ws = cnt = None
            if splits > 1:
                floats, rows = B * KV * splits * G * (hd + 2), B * KV
                if self.workspace.numel() < floats or self.counters.numel() < rows:
                    device = self.workspace.device
                    self.retired.append((self.workspace, self.counters))
                    self.workspace = torch.empty(max(floats, self.workspace.numel()),
                                                 dtype=torch.float32, device=device)
                    self.counters = torch.zeros(max(rows, self.counters.numel()),
                                                dtype=torch.int32, device=device)
                    # new shapes take the new buffers; earlier plans (and the
                    # graphs that captured them) keep their own
                ws, cnt = self.workspace.data_ptr(), self.counters.data_ptr()
            got = self.plans[key] = (pps, ws, cnt)
        return got


_FN = []                      # [(library, bound entry point)] once loaded
_DEVICES: dict[int, _Device] = {}
# the current stream's handle for a device index, without a Stream object
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None) or (
    lambda index: torch.cuda.current_stream(index).cuda_stream)


def bind(lib: ctypes.CDLL):
    """(library, entry point) with the entry point's argument types set."""
    fn = lib.paged_attention_fwd
    fn.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 8
                   + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, fn


def _entry():
    if not _FN:
        _FN.append(bind(build.load("paged_attention")))
    return _FN[0]


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                    block_table: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """q: (B, KV, G, hd); k_pages, v_pages: (num_pages, page_size, KV, hd);
    block_table: (B, nb) int32 page ids; lengths: (B,) int32 valid positions
    per row. Returns (B, KV, G, hd) in q's dtype.

    CUDA tensors on one device, all contiguous (a per-layer view ``pool[l]``
    of the model's (L, num_pages, page_size, KV, hd) cache is). q and the
    pools each take f32 or bf16; hd in ``HEAD_DIMS``; G <= ``MAX_GROUP``. Page
    ids must lie in [0, num_pages): the caller's page allocator guarantees
    it, and checking would cost a device-to-host copy per call. Calls on one
    device share the merge's workspace, so they must be ordered on one
    stream, as every path of the port is. The kernel launches on q's device
    and its current stream.
    """
    if not type(q) is type(k_pages) is type(v_pages) is torch.Tensor:
        dtensor.refuse("paged_attention", q, k_pages, v_pages, block_table, lengths)
    if not (q.is_cuda and k_pages.is_cuda and v_pages.is_cuda and block_table.is_cuda
            and lengths.is_cuda):
        raise ValueError("paged_attention launches the CUDA kernel: every argument "
                         "must be a CUDA tensor (ops.paged_attend runs the plain "
                         "version on the CPU)")
    dev = q.device
    if not (k_pages.device == dev and v_pages.device == dev and block_table.device == dev
            and lengths.device == dev):
        raise ValueError("paged_attention arguments lie on different devices")
    q_type, p_type = _DTYPES.get(q.dtype), _DTYPES.get(k_pages.dtype)
    if q_type is None or p_type is None or v_pages.dtype != k_pages.dtype:
        raise TypeError(f"paged_attention takes f32 or bf16 q and f32 or bf16 pages "
                        f"(k and v alike), got {q.dtype}, {k_pages.dtype}, {v_pages.dtype}")
    if block_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError(f"block_table and lengths must be int32, got "
                        f"{block_table.dtype} and {lengths.dtype}")
    qs, ks, ts = q.shape, k_pages.shape, block_table.shape
    if (len(qs) != 4 or len(ks) != 4 or v_pages.shape != ks or ks[2:] != qs[1::2]
            or len(ts) != 2 or ts[0] != qs[0] or lengths.shape != qs[:1]):
        raise ValueError(f"shapes: q {tuple(qs)}, k_pages {tuple(ks)}, v_pages "
                         f"{tuple(v_pages.shape)}, block_table {tuple(ts)}, "
                         f"lengths {tuple(lengths.shape)}")
    B, KV, G, hd = qs
    ps, nb = ks[1], ts[1]
    if hd not in HEAD_DIMS:
        raise ValueError(f"paged_attention is built for head dims {HEAD_DIMS}, got {hd}")
    if not (1 <= G <= MAX_GROUP and 1 <= B <= MAX_GRID_Y and nb >= 1 and ps >= 1):
        raise ValueError(f"unsupported extents B={B} KV={KV} G={G} page_size={ps} nb={nb}")
    if not (q.is_contiguous() and k_pages.is_contiguous() and v_pages.is_contiguous()
            and block_table.is_contiguous() and lengths.is_contiguous()):
        raise ValueError("paged_attention needs contiguous q, pools, block_table, lengths")
    k_ptr, v_ptr = k_pages.data_ptr(), v_pages.data_ptr()
    if k_ptr % 16 or v_ptr % 16:
        raise ValueError("paged_attention reads the pools in 16-byte copies: their data "
                         "must be 16-byte aligned")
    lib, fn = _entry()
    index = dev.index
    state = _DEVICES.get(index)
    if state is None:
        state = _DEVICES[index] = _Device(index)
    pps, ws, cnt = state.plan(B, KV, G, hd, nb, ps)
    out = torch.empty_like(q)
    err = fn(q_type, p_type, hd, q.data_ptr(), k_ptr, v_ptr, block_table.data_ptr(),
             lengths.data_ptr(), out.data_ptr(), ws, cnt, B, KV, G, ps, nb, pps,
             hd ** -0.5, index, _raw_stream(index))
    build.check(lib, err, "paged_attention")
    COUNTER.launches += 1
    return out
