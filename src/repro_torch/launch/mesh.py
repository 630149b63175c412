"""Serving and training meshes on ``torch.distributed``.

Port of ``repro.launch.mesh``. Single pod: (16, 16) = 256 ranks, axes
("data", "model"). Multi-pod: (2, 16, 16) = 512 ranks, axes ("pod", "data",
"model"); "pod" composes with "data" as the batch/FSDP axis, "model" stays
inside a pod. The host mesh is the degenerate 1 x 1 mesh of one process,
the twin of the reference's one-device mesh.

Building a mesh never happens at import. ``make_host_mesh`` starts a
process group of one rank when none is running: NCCL for a card, gloo for
the CPU. On a card it never falls back to gloo: a group that cannot be
built raises. The production meshes need a process group of 256 or 512
ranks already running (``torch.distributed.init_process_group`` with the
address, world size and rank given), and raise otherwise.
"""
from __future__ import annotations

import socket
from typing import Mapping

import torch
import torch.distributed as dist

AXES = ("data", "model")
MULTIPOD_AXES = ("pod", "data", "model")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _start_single_rank_group(device: torch.device) -> None:
    backend = "nccl" if device.type == "cuda" else "gloo"
    if backend == "nccl" and not dist.is_nccl_available():
        raise RuntimeError("a mesh on the card needs NCCL, which this torch lacks")
    dist.init_process_group(backend, init_method=f"tcp://localhost:{_free_port()}",
                            world_size=1, rank=0)


def make_host_mesh(device="cuda"):
    """The 1 x 1 ("data", "model") mesh of this process on ``device``. Starts
    a world-size-1 process group when none is running (NCCL on the card,
    gloo on the CPU); an existing group must have one rank."""
    from torch.distributed.device_mesh import init_device_mesh

    device = torch.device(device)
    if not dist.is_initialized():
        _start_single_rank_group(device)
    elif dist.get_world_size() != 1:
        raise RuntimeError(f"the host mesh is one rank; the running process group has "
                           f"{dist.get_world_size()}")
    elif device.type == "cuda" and dist.get_backend() != "nccl":
        raise RuntimeError(f"a mesh on the card needs an NCCL group; the running one is "
                           f"{dist.get_backend()}")
    return init_device_mesh(device.type, (1, 1), mesh_dim_names=AXES)


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """(16, 16) or (2, 16, 16) over a running process group of 256 or 512
    ranks; raises where the ranks are missing."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = MULTIPOD_AXES if multi_pod else AXES
    need = 1
    for n in shape:
        need *= n
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have != need:
        raise RuntimeError(f"the {'multipod' if multi_pod else 'production'} mesh needs "
                           f"{need} ranks; this process group has {have}")
    return init_device_mesh(torch.device(device).type, shape, mesh_dim_names=axes)


def axis_sizes(mesh) -> dict:
    """``{axis: size}`` of a ``DeviceMesh`` or of a mapping of axis name to
    size (the rule tables are pure functions of these sizes, so a mapping
    stands for a mesh no process group holds)."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def batch_axes(mesh) -> tuple[str, ...]:
    """The composed batch/FSDP axis: ("pod", "data") on multi-pod meshes."""
    return tuple(n for n in axis_sizes(mesh) if n in ("pod", "data"))
