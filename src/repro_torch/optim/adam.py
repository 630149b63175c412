"""Adam over trees of tensors (Kingma & Ba 2017).

Port of ``repro.optim.adam``: the paper optimizes BNS solvers with Adam. The
arithmetic is the reference's, not ``torch.optim.Adam``'s: ``eps`` is added
outside the square root of the bias-corrected second moment, the bias
corrections come from a counted step, and the moments are f32. A tree is a
tensor or a NamedTuple, tuple, list or dict of trees; ``tree_map`` applies a
function field by field, the port's counterpart of ``jax.tree.map``.
``adam_update_`` writes the same step into the tensors it is given, which a
CUDA graph holds by address (``core/bns.py::TrainLoop``, ``launch/train.py``),
one slice of at most ``SLICE`` elements at a time (a leaf's elements in
order), so a backbone's stacked leaves (yi-6b's ``w_gate`` is 1.44 B
elements) never take a whole-leaf f32 temporary. Both updates also take a
gradient leaf as its rows (a sequence of tensors, one a row of the param's
first axis): the backbone trainer differentiates each layer's view of a
stacked leaf and never stacks the gradients. ``adamw`` is the reference's
closure over a learning-rate schedule (the model trainer's).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

Tensor = torch.Tensor
Tree = object


def tree_map(fn, tree, *rest):
    """``fn`` applied leaf by leaf over trees of one structure."""
    if isinstance(tree, Tensor):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        out = [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
        if hasattr(tree, "_fields"):          # a NamedTuple keeps its type
            return type(tree)(*out)
        return type(tree)(out)
    raise TypeError(f"not a tree of tensors: {type(tree).__name__}")


def tree_leaves(tree) -> list[Tensor]:
    """The leaves in ``tree_map``'s order."""
    leaves: list[Tensor] = []
    tree_map(leaves.append, tree)
    return leaves


def tree_unflatten(tree, leaves) -> Tree:
    """``tree``'s structure with ``leaves`` (in ``tree_leaves`` order) in it."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


# elements an in-place update slice holds at most, by device type: on the card
# few enough slices a step for its graph, on the CPU few enough that a slice's
# temporaries stay in the caches and come from the heap (at the card's size
# each CPU temporary was mapped and faulted in afresh: ~4x the time)
SLICE = {"cuda": 1 << 26, "cpu": 1 << 20}


def _slices(x: Tensor, *, written: bool = False) -> list[Tensor]:
    """``x`` flattened in its elements' order, as consecutive views of at
    most its device's ``SLICE`` elements (``[x]`` where it holds no more).
    A ``written`` tensor (a param or moment) must be viewable flat; a
    gradient that is not is read from a flat copy."""
    n = SLICE.get(x.device.type, SLICE["cpu"])
    if x.numel() <= n:
        return [x]
    return list((x.view(-1) if written else x.reshape(-1)).split(n))


def _chunks(g) -> list[Tensor]:
    """A gradient leaf's slices: ``_slices`` of a tensor, or of each row of a
    leaf given as its rows."""
    if isinstance(g, Tensor):
        return _slices(g)
    return [s for row in g for s in _slices(row)]


def _parts(x: Tensor, g) -> list[Tensor]:
    """The slices of a param or moment ``x`` that line up with ``_chunks(g)``."""
    rows = [x] if isinstance(g, Tensor) else x.unbind(0)
    return [s for row in rows for s in _slices(row, written=True)]


def _grad_leaves(grads, params) -> list:
    """``grads``' leaves in ``tree_leaves(params)`` order, a leaf given as its
    rows kept whole."""
    if isinstance(params, Tensor):
        return [grads]
    if isinstance(params, dict):
        return [x for k in params for x in _grad_leaves(grads[k], params[k])]
    return [x for g, p in zip(grads, params) for x in _grad_leaves(g, p)]


def global_norm(leaves) -> Tensor:
    """sqrt of the f32 sum of squares over gradient ``leaves``, each leaf's
    square summed slice by slice (``_chunks``; one sum a leaf for the small
    trees of the solvers)."""
    return torch.sqrt(sum(torch.sum(s.to(torch.float32) ** 2)
                          for g in leaves for s in _chunks(g)))


class AdamState(NamedTuple):
    step: Tensor      # 0-d int32: updates taken so far
    mu: Tree
    nu: Tree


def adam_init(params: Tree, dtype=torch.float32) -> AdamState:
    first = tree_leaves(params)[0]
    zeros = lambda p: torch.zeros_like(p, dtype=dtype)  # noqa: E731
    return AdamState(step=torch.zeros((), dtype=torch.int32, device=first.device),
                     mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def adam_update(
    grads: Tree,
    state: AdamState,
    params: Tree,
    lr,
    *,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    grad_clip_norm: float | None = None,
) -> tuple[Tree, AdamState]:
    """One AdamW step; returns (new_params, new_state). New tensors, nothing
    updated in place; call it under ``torch.no_grad()``. A gradient leaf
    given as its rows is stacked (after the clip norm is taken over them)."""
    step = state.step + 1
    g_leaves = _grad_leaves(grads, params)
    scale = None if grad_clip_norm is None else _clip_scale(g_leaves, grad_clip_norm)
    g_leaves = [g if isinstance(g, Tensor) else torch.stack(list(g)) for g in g_leaves]
    if scale is not None:
        g_leaves = [g * scale for g in g_leaves]
    grads = tree_unflatten(params, g_leaves)

    mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.to(m.dtype), state.mu, grads)
    nu = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(g.to(v.dtype)),
                  state.nu, grads)
    step_f = step.to(torch.float32)
    bc1 = 1 - b1 ** step_f
    bc2 = 1 - b2 ** step_f

    def upd(p, m, v):
        update = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        if weight_decay:
            update = update + weight_decay * p.to(update.dtype)
        return (p.to(torch.float32) - lr * update).to(p.dtype)

    new_params = tree_map(upd, params, mu, nu)
    return new_params, AdamState(step=step, mu=mu, nu=nu)


def _clip_scale(leaves, grad_clip_norm: float) -> Tensor:
    return torch.clamp(grad_clip_norm / torch.clamp(global_norm(leaves), min=1e-12), max=1.0)


def adam_update_(grads: Tree, state: AdamState, params: Tree, lr, *, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 0.0,
                 grad_clip_norm: float | None = None) -> None:
    """``adam_update`` in place: the new params, moments and step are written
    into ``params``' leaves and ``state``'s tensors, bit-equal to the new
    tensors ``adam_update`` returns (same options). The clip norm is taken
    over every leaf first; then each leaf is updated one slice at a time
    (``_chunks``: the arithmetic is elementwise, so slicing changes no bit).
    Call it under ``torch.no_grad()``."""
    g_leaves = _grad_leaves(grads, params)
    scale = None if grad_clip_norm is None else _clip_scale(g_leaves, grad_clip_norm)
    step = state.step + 1
    step_f = step.to(torch.float32)
    bc1 = 1 - b1 ** step_f
    bc2 = 1 - b2 ** step_f
    for p, m, v, g in zip(tree_leaves(params), tree_leaves(state.mu),
                          tree_leaves(state.nu), g_leaves):
        for ps, ms, vs, gs in zip(_parts(p, g), _parts(m, g), _parts(v, g), _chunks(g)):
            if scale is not None:
                gs = gs * scale
            ms.copy_(b1 * ms + (1 - b1) * gs.to(ms.dtype))
            vs.copy_(b2 * vs + (1 - b2) * torch.square(gs.to(vs.dtype)))
            update = (ms / bc1) / (torch.sqrt(vs / bc2) + eps)
            if weight_decay:
                update = update + weight_decay * ps.to(update.dtype)
            ps.copy_((ps.to(torch.float32) - lr * update).to(ps.dtype))
    state.step.copy_(step)


def adamw(lr_fn: Callable, **kwargs):
    """Closure-style API: returns (init_fn, update_fn) with a learning-rate
    schedule, the reference's ``adamw``; ``update_fn(grads, state, params)``
    takes the rate ``lr_fn(state.step)`` before the step is counted and
    returns (new_params, new_state), as ``adam_update`` does."""

    def init(params):
        return adam_init(params)

    def update(grads, state, params):
        return adam_update(grads, state, params, lr_fn(state.step), **kwargs)

    return init, update
