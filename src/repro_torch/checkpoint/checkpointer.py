"""Msgpack tree checkpointer, the port's copy of ``repro.checkpoint.checkpointer``.

Stores tensors as raw numpy bytes with dtype/shape metadata and JSON meta
beside them. The format is the reference's, byte for byte: leaves go in the
order ``jax.tree.leaves`` gives (NamedTuple, tuple and list fields in order,
dict keys sorted), each ``{b"dtype", b"shape", b"data"}``, packed by the same
``msgpack.packb`` call. A file either package writes restores in the other,
and the same tree and meta give the same bytes.
"""
from __future__ import annotations

import json
import os
from typing import Any

import msgpack
import numpy as np
import torch


def _leaves(tree) -> list:
    """The leaves in ``jax.tree.leaves`` order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _unflatten(template, it):
    """``template``'s structure filled from the iterator ``it`` of leaves."""
    if isinstance(template, dict):
        filled = {k: _unflatten(template[k], it) for k in sorted(template)}
        return {k: filled[k] for k in template}
    if isinstance(template, (tuple, list)):
        out = [_unflatten(v, it) for v in template]
        if hasattr(template, "_fields"):          # a NamedTuple keeps its type
            return type(template)(*out)
        return type(template)(out)
    return next(it)


def _pack_leaf(x) -> dict:
    arr = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return {b"dtype": arr.dtype.str.encode(), b"shape": list(arr.shape),
            b"data": arr.tobytes()}


def _unpack_leaf(d: dict) -> np.ndarray:
    return np.frombuffer(d[b"data"], dtype=np.dtype(d[b"dtype"].decode())) \
        .reshape(d[b"shape"])


def save(path: str, tree: Any, meta: dict | None = None) -> None:
    """Save a tree of tensors; ``meta`` (JSON-serializable) rides along if given."""
    payload = {b"leaves": [_pack_leaf(x) for x in _leaves(tree)]}
    if meta is not None:
        payload[b"meta"] = json.dumps(meta).encode()
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(tmp, "wb") as f:
        f.write(msgpack.packb(payload))
    os.replace(tmp, path)


def restore(path: str, template: Any, device: str | torch.device = "cpu") -> Any:
    """The tree saved at ``path`` in ``template``'s structure: each leaf a new
    tensor on ``device`` in its template leaf's dtype, converted from the
    stored dtype in one step."""
    with open(path, "rb") as f:
        payload = msgpack.unpackb(f.read())
    arrays = [_unpack_leaf(d) for d in payload[b"leaves"]]
    t_leaves = _leaves(template)
    assert len(arrays) == len(t_leaves), (
        f"checkpoint has {len(arrays)} leaves, template {len(t_leaves)}")
    leaves = [torch.from_numpy(a.copy()).to(device=device, dtype=t.dtype)
              for a, t in zip(arrays, t_leaves)]
    return _unflatten(template, iter(leaves))


def load_meta(path: str) -> dict | None:
    """Read only the JSON metadata written by ``save(..., meta=...)``."""
    with open(path, "rb") as f:
        payload = msgpack.unpackb(f.read())
    raw = payload.get(b"meta")
    return None if raw is None else json.loads(raw.decode())


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(f.split("_")[1].split(".")[0]) for f in os.listdir(ckpt_dir)
             if f.startswith("step_") and f.endswith(".msgpack")]
    return max(steps) if steps else None


def step_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step}.msgpack")
