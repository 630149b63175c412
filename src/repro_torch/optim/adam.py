"""Adam over trees of tensors (Kingma & Ba 2017).

Port of ``repro.optim.adam``: the paper optimizes BNS solvers with Adam. The
arithmetic is the reference's, not ``torch.optim.Adam``'s: ``eps`` is added
outside the square root of the bias-corrected second moment, the bias
corrections come from a counted step, and the moments are f32. A tree is a
tensor or a NamedTuple, tuple, list or dict of trees; ``tree_map`` applies a
function field by field, the port's counterpart of ``jax.tree.map``.
``adam_update_`` writes the same step into the tensors it is given, which a
CUDA graph holds by address (``core/bns.py::TrainLoop``). The AdamW closure
(``adamw``) comes with the model trainer (ROADMAP Queue A item 11).
"""
from __future__ import annotations

from typing import NamedTuple

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
    updated in place; call it under ``torch.no_grad()``."""
    step = state.step + 1
    if grad_clip_norm is not None:
        gnorm = torch.sqrt(sum(torch.sum(g.to(torch.float32) ** 2)
                               for g in tree_leaves(grads)))
        scale = torch.clamp(grad_clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
        grads = tree_map(lambda g: g * scale, grads)

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


def adam_update_(grads: Tree, state: AdamState, params: Tree, lr, **options) -> None:
    """``adam_update`` in place: the new params, moments and step are written
    into ``params``' leaves and ``state``'s tensors, bit-equal to the new
    tensors ``adam_update`` returns (same options). Call it under
    ``torch.no_grad()``."""
    new_params, new_state = adam_update(grads, state, params, lr, **options)
    for dst, src in zip(tree_leaves((params, state)), tree_leaves((new_params, new_state))):
        dst.copy_(src)
