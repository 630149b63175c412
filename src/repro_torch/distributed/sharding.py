"""Sharding rules: parameter and decode-state specs per architecture.

Port of ``repro.distributed.sharding``, the same table (Megatron + FSDP,
expert-parallel for MoE):
  * ``model`` axis — tensor parallelism: attention head dims and FFN hidden
    dims column/row sharded; MoE experts sharded; vocab sharded when
    divisible.
  * batch axes (``data``, composed with ``pod`` on multi-pod meshes) — batch
    sharding for activations and FSDP sharding for weights.

A ``Spec`` is the port's ``PartitionSpec``: one entry a dimension, each an
axis name, a tuple of axis names or None (replicated along that dim); an
empty ``Spec()`` replicates a leaf of any rank. Rules match parameter paths
(``/``-joined dict keys, sequence indices and NamedTuple field names, as
the reference's pytree paths read); anything unmatched is replicated. Every
function here is pure: it reads the paths, the leaves' shapes and the
mesh's axis sizes (a ``DeviceMesh``, or a mapping of axis name to size).
"""
from __future__ import annotations

import re
from typing import Callable, Sequence

from repro_torch.launch.mesh import axis_sizes, batch_axes


class Spec(tuple):
    """Per-dimension placement: ``Spec(None, "data", "model")``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)


def tree_map_with_path(fn: Callable, tree, path: tuple = ()):
    """``fn(path, leaf)`` over nested dicts, lists, tuples and NamedTuples
    (path entries: dict keys, sequence indices, field names; a ``Spec`` is
    a leaf); returns the same structure."""
    if isinstance(tree, Spec):
        return fn("/".join(path), tree)
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map_with_path(fn, v, path + (f,))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn("/".join(path), tree)


_COL = "col"                 # (..., d_in, d_out_sharded)   -> (*, b, model)
_ROW = "row"                 # (..., d_in_sharded, d_out)   -> (*, model, b)
_EXPERT_COL = "expert_col"   # (L, E, d, d_e) -> (None, model, b, None)
_EXPERT_ROW = "expert_row"   # (L, E, d_e, d) -> (None, model, None, b)
_VOCAB_IN = "vocab_in"       # (V, d) embeddings
_VOCAB_OUT = "vocab_out"     # (d, V) lm head
_HEADS = "heads"             # (L, nheads) per-head scalars
_DINNER = "dinner"           # (L, d_inner) vectors sharded on model
_REPL = "repl"

_RULES: Sequence[tuple[str, str]] = (
    (r".*attn/wq$", _COL),
    (r".*attn/wk$", _COL),
    (r".*attn/wv$", _COL),
    (r".*attn/wo$", _ROW),
    (r".*mlp/w_gate$", _COL),
    (r".*mlp/w_up$", _COL),
    (r".*mlp/w_down$", _ROW),
    (r".*mlp/w1$", _COL),
    (r".*mlp/w2$", _ROW),
    (r".*moe/router$", "router"),
    (r".*moe/w_gate$", _EXPERT_COL),
    (r".*moe/w_up$", _EXPERT_COL),
    (r".*moe/w_down$", _EXPERT_ROW),
    (r".*tm/w[rkvg]$", _COL),
    (r".*tm/wo$", _ROW),
    (r".*cm/wk$", _COL),
    (r".*cm/wv$", _ROW),
    (r".*cm/wr$", _COL),
    (r".*in_proj$", _COL),
    (r".*out_proj$", _ROW),
    (r".*conv_w$", "conv"),
    (r".*(A_log|dt_bias|/D)$", _HEADS),
    (r".*gate_norm$", _DINNER),
    (r".*projector/w[12]$", _COL),
    (r"^embed$", _VOCAB_IN),
    (r".*latent_embed$", _VOCAB_IN),
    (r"^lm_head$", _VOCAB_OUT),
    (r".*proj_in$", _COL),
    (r".*proj_out$", _ROW),
    (r".*time_w1$", _COL),
    (r".*time_w2$", _ROW),
)


def _batch_entry(mesh):
    """The composed batch axes as one spec entry: a name, a tuple, or None."""
    b = batch_axes(mesh)
    return b if len(b) > 1 else (b[0] if b else None)


def _size(sizes: dict, entry) -> int:
    total = 1
    for a in ((entry,) if isinstance(entry, str) else entry):
        total *= sizes[a]
    return total


def _div(dim: int, sizes: dict, b) -> bool:
    return b is not None and dim % _size(sizes, b) == 0


def rule_kind(path: str) -> str:
    """The rule a parameter path matches (``"repl"`` when none does)."""
    for pat, kind in _RULES:
        if re.match(pat, path):
            return kind
    return _REPL


def param_specs(params, cfg, mesh):
    """The tree of ``Spec`` matching ``params`` (tensors, or anything with a
    ``shape``)."""
    sizes = axis_sizes(mesh)
    b = _batch_entry(mesh)
    model_parts = sizes["model"]

    def spec_for(name: str, leaf) -> Spec:
        shape = tuple(leaf.shape)
        ndim = len(shape)
        kind = rule_kind(name)
        if kind == _REPL or ndim <= 1:
            return Spec()
        lead = (None,) * (ndim - 2)
        if kind == _COL:
            # (..., d_in, d_out): FSDP on d_in, tensor on d_out, if divisible
            din, dout = shape[-2], shape[-1]
            return Spec(*lead, b if _div(din, sizes, b) else None,
                        "model" if dout % model_parts == 0 else None)
        if kind == _ROW:
            din, dout = shape[-2], shape[-1]
            return Spec(*lead, "model" if din % model_parts == 0 else None,
                        b if _div(dout, sizes, b) else None)
        if kind == _EXPERT_COL:
            return Spec(None, "model", b, None)
        if kind == _EXPERT_ROW:
            return Spec(None, "model", None, b)
        if kind == "router":
            return Spec(*lead, b, None)
        if kind == "conv":           # (L, k, conv_dim)
            return Spec(*(None,) * (ndim - 1), "model")
        if kind == _HEADS:           # (L, n_heads)
            return Spec(*(None,) * (ndim - 1),
                        "model" if shape[-1] % model_parts == 0 else None)
        if kind == _DINNER:
            return Spec(*(None,) * (ndim - 1), "model")
        if kind == _VOCAB_IN:        # (V, d)
            return Spec("model" if shape[0] % model_parts == 0 else None, b)
        if kind == _VOCAB_OUT:       # (d, V)
            return Spec(b, "model" if shape[-1] % model_parts == 0 else None)
        return Spec()

    return tree_map_with_path(spec_for, params)


def _batch_split(mesh, batch: int):
    """(composed batch entry, the entry if ``batch`` splits over it else None)."""
    sizes = axis_sizes(mesh)
    b = batch_axes(mesh)
    b = b if len(b) > 1 else b[0]
    bt = _size(sizes, b)
    return b, (b if batch % bt == 0 and batch >= bt else None)


def state_specs(state, cfg, mesh, batch: int):
    """Specs for a slot-batched decode state, by field name and shape:
      KVCache.k/v                    (L, B, slots, KV, hd)
      PagedKVCache.k_pages/v_pages   (L, num_pages, page_size, KV, hd) — no
        batch axis; KV heads on ``model`` when divisible. The block table
        and per-row index stay replicated.
      RWKVState.shift_*  (L, B, d)        wkv (L, B, H, dk, dv)
      HybridState.conv   (L, B, k, conv)  ssm (L, B, nh, ds, hd)
      EncDecState.memory (B, M, d)
    """
    b, batch_s = _batch_split(mesh, batch)
    mp = axis_sizes(mesh)["model"]

    def spec_for(name: str, leaf) -> Spec:
        shape = tuple(leaf.shape)
        if not shape:
            return Spec()                                   # index scalar
        if name in ("k_pages", "v_pages"):
            return Spec(None, None, None, "model" if shape[3] % mp == 0 else None, None)
        if name == "block_table":
            return Spec()
        if name in ("k", "v", "kv", "vv"):                  # (L/sites, B, slots, KV, hd)
            if shape[3] % mp == 0:
                return Spec(None, batch_s, None, "model", None)
            if batch_s is None:
                return Spec(None, None, b, None, None)      # seq-sharded decode
            return Spec(None, batch_s, "model", None, None)
        if name == "memory":                                # (B, M, d)
            return Spec(batch_s, None, "model" if shape[-1] % mp == 0 else None)
        if name in ("shift_tm", "shift_cm"):                # (L, B, d)
            return Spec(None, batch_s, "model")
        if name == "wkv":                                   # (L, B, H, dk, dv)
            return Spec(None, batch_s, "model" if shape[2] % mp == 0 else None, None, None)
        if name == "conv":                                  # (L, B, k, conv_dim)
            return Spec(None, batch_s, None, "model" if shape[-1] % mp == 0 else None)
        if name == "ssm":                                   # (L, B, nh, ds, hd)
            return Spec(None, batch_s, "model" if shape[2] % mp == 0 else None, None, None)
        return Spec()

    return tree_map_with_path(spec_for, state)


def batch_spec(mesh, extra_dims: int = 1) -> Spec:
    """Inputs (B, ...): batch over the composed data axes."""
    b = batch_axes(mesh)
    return Spec(b if len(b) > 1 else b[0], *(None,) * extra_dims)


def cache_spec(mesh, cfg, batch: int, *, seq_axis_fallback: bool = True) -> Spec:
    """KV cache (L, B, slots, KV, hd): batch if it divides, heads on
    ``model`` if divisible, else the sequence (slots) dim — on the data
    axes at batch 1 (distributed-softmax decode), on ``model`` otherwise."""
    b, batch_s = _batch_split(mesh, batch)
    if cfg.n_kv_heads % axis_sizes(mesh)["model"] == 0:
        return Spec(None, batch_s, None, "model", None)
    if batch_s is None and seq_axis_fallback:
        return Spec(None, None, b, None, None)
    return Spec(None, batch_s, "model", None, None)
