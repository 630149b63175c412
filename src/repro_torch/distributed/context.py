"""Ambient sharding context for model-internal sharding constraints.

Port of ``repro.distributed.context``. Models are mesh-agnostic; a launcher
installs a context and hot layers may place ``constrain(x, *spec)`` hints.
With no context installed every helper is a no-op, as in the reference. No
launcher of the port installs one: in the reference only the dry run does
(``launch/dryrun.py``, XLA-only and not ported); its trainer and the port's
(``launch/train.py``) run without one, and ``models.model.cfm_loss`` places
its ``constrain`` hints where the reference's does.

Policies:
  seq_parallel_attn — shard attention over query positions on the ``model``
      axis instead of heads (head counts that do not divide the axis).
  q_chunk — blockwise attention over query chunks for long prefill.
  flash_attention — attention through the flash kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.launch.mesh import batch_axes


@dataclasses.dataclass
class ShardingContext:
    mesh: object
    batch_axes: tuple
    seq_parallel_attn: bool = False
    q_chunk: int = 0
    flash_attention: bool = False


_CTX: Optional[ShardingContext] = None


def install(mesh, *, seq_parallel_attn: bool = False, q_chunk: int = 0,
            flash_attention: bool = False) -> ShardingContext:
    global _CTX
    _CTX = ShardingContext(mesh=mesh, batch_axes=batch_axes(mesh),
                           seq_parallel_attn=seq_parallel_attn, q_chunk=q_chunk,
                           flash_attention=flash_attention)
    return _CTX


def clear() -> None:
    global _CTX
    _CTX = None


def active() -> Optional[ShardingContext]:
    return _CTX


def batch_axis():
    if _CTX is None:
        return None
    b = _CTX.batch_axes
    return b if len(b) > 1 else b[0]


def constrain(x, *spec):
    """Redistribute a DTensor ``x`` to ``spec`` (one entry a dimension: an
    axis name, a tuple of names, None for replicated, "?" to keep what ``x``
    has along that dim) when a context is installed; else identity. A plain
    tensor is a rank's local value and passes through."""
    if _CTX is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    from repro_torch.serving.sharded import placements_for

    keep = {p.dim for p in x.placements if hasattr(p, "dim")}
    placements = placements_for(_CTX.mesh, tuple(
        None if s == "?" else s for s in spec))
    placements = [old if (getattr(old, "dim", None) in keep
                          and spec[old.dim] == "?") else new
                  for old, new in zip(x.placements, placements)]
    return x.redistribute(x.device_mesh, placements)


def seq_parallel_attn_enabled() -> bool:
    return _CTX is not None and _CTX.seq_parallel_attn


def q_chunk() -> int:
    return _CTX.q_chunk if _CTX is not None else 0


def flash_attention_enabled() -> bool:
    return _CTX is not None and _CTX.flash_attention
