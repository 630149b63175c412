"""The port's Adam and learning-rate schedules against the JAX reference, on
the CPU.

Random trees (a NamedTuple of the BNS parameter shapes, and a dict) and
random gradients are made with numpy from a seed and handed to both sides;
20 steps of ``adam_update`` with a schedule's learning rate must agree. f32
throughout: tolerance ``tests/test_kernels.py``'s f32 2e-5 (rtol and atol)
on the parameters after 20 steps, and 1e-6 relative on the schedules (one
f32 expression each).
"""
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adam as jadam
from repro.optim import schedule as jsched
from repro_torch.optim import adam as tadam
from repro_torch.optim import schedule as tsched

TOL = 2e-5
N = 8


class Theta(NamedTuple):
    time_logits: object
    a: object
    b: object


SCHEDULES = {
    "constant": lambda m: m.constant_schedule(3e-3),
    "poly": lambda m: m.poly_decay(1e-2, 20),
    "poly_power_end": lambda m: m.poly_decay(1e-2, 15, power=2.0, end_lr=1e-4),
    "cosine": lambda m: m.cosine_annealing(1e-2, 20),
    "cosine_end": lambda m: m.cosine_annealing(5e-3, 12, end_lr=1e-3),
    "warmup_cosine": lambda m: m.warmup_cosine(1e-2, 5, 20),
}


def _tree(kind, rng):
    if kind == "bns":
        return Theta(*(rng.standard_normal(s).astype(np.float32)
                       for s in ((N,), (N,), (N, N))))
    return {"w": rng.standard_normal((3, 5)).astype(np.float32),
            "nested": {"b": rng.standard_normal((5,)).astype(np.float32)}}


def _to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _to_torch(tree):
    return tadam.tree_map(lambda x: x, jax.tree.map(torch.from_numpy, tree))


@pytest.mark.parametrize("name", sorted(SCHEDULES))
@pytest.mark.parametrize("as_tensor", [False, True])
def test_schedule_matches_reference(name, as_tensor):
    jfn, tfn = SCHEDULES[name](jsched), SCHEDULES[name](tsched)
    for step in range(26):
        want = float(jfn(jnp.asarray(step, jnp.int32)))
        got = tfn(torch.tensor(step, dtype=torch.int32) if as_tensor else step)
        assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("kind", ["bns", "dict"])
@pytest.mark.parametrize("schedule", ["poly", "cosine", "warmup_cosine"])
@pytest.mark.parametrize("options", [{}, {"weight_decay": 0.01},
                                     {"grad_clip_norm": 0.5},
                                     {"b1": 0.8, "b2": 0.99, "eps": 1e-6}])
def test_adam_update_matches_reference_over_20_steps(kind, schedule, options):
    """eps outside the square root, bias correction from the counted step,
    f32 moments: the port's arithmetic is the reference's, not torch.optim's."""
    rng = np.random.default_rng(len(kind) * 100 + len(schedule) + len(options))
    p0 = _tree(kind, rng)
    jp, tp = _to_jax(p0), _to_torch(p0)
    jst, tst = jadam.adam_init(jp), tadam.adam_init(tp)
    jlr, tlr = SCHEDULES[schedule](jsched), SCHEDULES[schedule](tsched)
    jstep = jax.jit(lambda g, s, p, lr: jadam.adam_update(g, s, p, lr, **options))
    for it in range(20):
        g = _tree(kind, rng)
        jp, jst = jstep(_to_jax(g), jst, jp, jlr(jnp.asarray(it)))
        tp, tst = tadam.adam_update(_to_torch(g), tst, tp, tlr(it), **options)
    assert int(tst.step) == int(jst.step) == 20 and tst.step.dtype == torch.int32
    for got, want in ((tp, jp), (tst.mu, jst.mu), (tst.nu, jst.nu)):
        for x, y in zip(tadam.tree_leaves(got), jax.tree.leaves(want)):
            assert x.dtype == torch.float32
            np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=TOL, atol=TOL)
    if kind == "bns":
        assert isinstance(tp, Theta)


@pytest.mark.parametrize("kind", ["bns", "dict"])
@pytest.mark.parametrize("schedule", ["poly", "cosine", "warmup_cosine"])
@pytest.mark.parametrize("options", [{}, {"weight_decay": 0.01},
                                     {"grad_clip_norm": 0.5},
                                     {"b1": 0.8, "b2": 0.99, "eps": 1e-6}])
def test_adam_update_in_place_equals_adam_update_over_20_steps(kind, schedule, options):
    """``adam_update_`` writes into the tensors it is given (a CUDA graph
    holds them by address) exactly what ``adam_update`` returns: 20 steps
    side by side, equal to the bit, every leaf at its first address."""
    rng = np.random.default_rng(len(kind) * 100 + len(schedule) + len(options))
    p0 = _tree(kind, rng)
    new_p = _to_torch(p0)
    new_st = tadam.adam_init(new_p)
    p, st = tadam.tree_map(torch.clone, new_p), tadam.adam_init(new_p)
    addresses = [x.data_ptr() for x in tadam.tree_leaves((p, st))]
    lr_fn = SCHEDULES[schedule](tsched)
    for it in range(20):
        g = _to_torch(_tree(kind, rng))
        new_p, new_st = tadam.adam_update(g, new_st, new_p, lr_fn(it), **options)
        assert tadam.adam_update_(g, st, p, lr_fn(st.step), **options) is None
        for x, y in zip(tadam.tree_leaves((p, st)), tadam.tree_leaves((new_p, new_st))):
            assert x.dtype == y.dtype and torch.equal(x, y)
    assert [x.data_ptr() for x in tadam.tree_leaves((p, st))] == addresses
    assert int(st.step) == 20 and st.step.dtype == torch.int32


def test_adam_is_not_torch_optim_adam():
    """torch.optim.Adam puts eps elsewhere in effect on tiny second moments;
    the port follows the reference: with v = 0 and m != 0 the first step is
    lr * sign(g) exactly (m / bc1 = g, sqrt(v / bc2) = |g|)."""
    p = {"x": torch.tensor([1.0, -2.0, 3.0])}
    g = {"x": torch.tensor([1e-3, -5.0, 0.25])}
    new, state = tadam.adam_update(g, tadam.adam_init(p), p, 0.1)
    np.testing.assert_allclose(new["x"].numpy(),
                               (p["x"] - 0.1 * torch.sign(g["x"]) * torch.abs(g["x"])
                                / (torch.abs(g["x"]) + 1e-8)).numpy(), rtol=1e-6)
    assert state.step.shape == () and int(state.step) == 1


def test_tree_helpers_keep_structure():
    t = Theta(torch.zeros(2), torch.ones(3), {"k": torch.full((1,), 2.0)})
    doubled = tadam.tree_map(lambda x: 2 * x, t)
    assert isinstance(doubled, Theta) and float(doubled.b["k"]) == 4.0
    leaves = tadam.tree_leaves(t)
    assert [x.shape for x in leaves] == [(2,), (3,), (1,)]
    back = tadam.tree_unflatten(t, [x + 1 for x in leaves])
    assert isinstance(back, Theta) and float(back.b["k"]) == 3.0
    with pytest.raises(TypeError, match="not a tree"):
        tadam.tree_map(lambda x: x, Theta(1, 2, 3))
