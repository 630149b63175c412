"""DTensors at the kernel entries: every kernel runs on each rank's local shard.

The port's kernels are bound through ctypes and read ``data_ptr()``, so a
DTensor (``serving.sharded``'s placement) cannot reach them. Each kernel
entry of the mesh path (``ns_update.ops.fused_ns_update``,
``flash_attention.ops.attend`` and ``paged_attend``, ``gla_scan.ops.gla``) sends a call with a
DTensor argument through ``local_call``, which wraps the entry in
``torch.distributed.tensor.experimental.local_map``: the inputs are
redistributed to the kernel's shardable split (the batch over the data
axes; the heads over ``model`` where every head count divides it), the
entry runs on the local shards (the kernel on the card, its plain version
on the CPU) and its output comes back as a DTensor of that split. The
CUDA-only launchers refuse a DTensor (``refuse``), so none can fall through
to a pointer read or to a plain version on the card.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

_DTENSOR = None
BATCH_AXES = ("pod", "data")


def _dtensor_type():
    global _DTENSOR
    if _DTENSOR is None:
        from torch.distributed.tensor import DTensor

        _DTENSOR = DTensor
    return _DTENSOR


def any_dtensor(*xs) -> bool:
    dt = _dtensor_type()
    return any(isinstance(x, dt) for x in xs)


def refuse(what: str, *xs) -> None:
    """Raise where a DTensor reached a CUDA-only launcher."""
    if any_dtensor(*xs):
        raise TypeError(f"{what} launches a CUDA kernel on raw pointers and got a DTensor "
                        "with no local_map around it: call it through its entry in the "
                        "kernel's ops module, which runs the kernel on each rank's local "
                        "shard (repro_torch.kernels.dtensor.local_call)")


def _splits(mesh, args, dims: Sequence[Optional[int]], axes) -> bool:
    """Whether every arg's listed dim splits evenly over the mesh axes named."""
    parts = 1
    for i, name in enumerate(mesh.mesh_dim_names):
        if name in axes:
            parts *= mesh.size(i)
    return all(d is None or x is None or x.shape[d] % parts == 0
               for x, d in zip(args, dims))


def placements(mesh, batch_dim: Optional[int], head_dim: Optional[int],
               split_batch: bool, split_heads: bool) -> tuple:
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for i, name in enumerate(mesh.mesh_dim_names):
        if mesh.size(i) == 1:        # one rank: its shard is the whole tensor
            out.append(Replicate())
        elif name in BATCH_AXES and split_batch and batch_dim is not None:
            out.append(Shard(batch_dim))
        elif name == "model" and split_heads and head_dim is not None:
            out.append(Shard(head_dim))
        else:
            out.append(Replicate())
    return tuple(out)


class _ContiguousGrad(torch.autograd.Function):
    """Identity whose backward makes the gradient contiguous."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad.contiguous()


def contiguous_grads(*xs):
    """``xs`` with their gradients made contiguous on the way back. Inside
    ``local_map`` a local gradient leaves as a DTensor's shard as it is,
    and a transposed one (an einsum's) is read by a later view of the
    DTensor, which needs a contiguous shard."""
    return tuple(_ContiguousGrad.apply(x) if x is not None and x.requires_grad else x
                 for x in xs)


def local_call(fn: Callable, args: tuple, *, batch_dims: Sequence[Optional[int]],
               head_dims: Sequence[Optional[int]], out_batch_dim, out_head_dim):
    """``fn(*args)`` on each rank's local shards, through ``local_map``.

    ``batch_dims``/``head_dims`` name each argument's batch and head dim (None:
    it has none and is replicated along that split); the batch splits over
    the data axes where every batch extent divides them, the heads over
    ``model`` where every head extent does. A plain tensor argument is
    taken as replicated. Returns a DTensor laid out by ``out_batch_dim`` /
    ``out_head_dim``, or, where ``fn`` returns a tuple, a tuple of DTensors
    laid out by the tuples ``out_batch_dim`` / ``out_head_dim``."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.experimental import local_map

    from torch.distributed.tensor import Partial

    mesh = next(x.device_mesh for x in args if isinstance(x, DTensor))
    split_b = _splits(mesh, args, batch_dims, BATCH_AXES)
    split_h = _splits(mesh, args, head_dims, ("model",))
    # an argument whole along an axis that splits the work (one group of q
    # and k over split heads) gets a partial gradient from each rank there
    work = placements(mesh, 0, 0, split_b, split_h)
    dargs, in_pl, grad_pl = [], [], []
    for x, bd, hd in zip(args, batch_dims, head_dims):
        if x is None:
            dargs.append(None)
            in_pl.append(None)
            grad_pl.append(None)
            continue
        if not isinstance(x, DTensor):
            x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)
        dargs.append(x)
        pl = placements(mesh, bd, hd, split_b, split_h)
        in_pl.append(pl)
        grad_pl.append(tuple(Partial() if isinstance(p, Replicate) and not isinstance(
            w, Replicate) else p for p, w in zip(pl, work)))
    if isinstance(out_batch_dim, tuple):
        out_pl = tuple(list(placements(mesh, bd, hd, split_b, split_h))
                       for bd, hd in zip(out_batch_dim, out_head_dim))
    else:
        out_pl = list(placements(mesh, out_batch_dim, out_head_dim, split_b, split_h))
    return local_map(lambda *xs: fn(*contiguous_grads(*xs)), out_pl,
                     in_placements=tuple(in_pl), in_grad_placements=tuple(grad_pl),
                     device_mesh=mesh, redistribute_inputs=True)(*dargs)


def shard_extent(mesh, placements, dim: int, size: int) -> tuple[int, int]:
    """(first index, extent) of this rank's part of a tensor dim of ``size``
    laid out by ``placements`` on ``mesh``: each mesh axis that splits the
    dim, in mesh order, cuts the part before it into chunks as
    ``torch.chunk`` does (the last ranks' parts may be short or empty)."""
    from torch.distributed.tensor import Shard

    first, part, coord = 0, size, mesh.get_coordinate()
    for i, pl in enumerate(placements):
        if isinstance(pl, Shard) and pl.dim == dim:
            chunk = -(-part // mesh.size(i))
            first += coord[i] * chunk
            part = max(0, min(chunk, part - coord[i] * chunk))
    return first, part
