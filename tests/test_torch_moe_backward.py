"""The MoE dispatch gather's backward (``models/moe.py::_Dispatch``), on the
CPU.

The scatter dispatch gathers each token into the slots it fills. Autograd
of that gather (``index_select``) adds a token's k slot gradients into its
row with ``index_add_``, which sums with float atomics in no fixed order on
the card; ``_Dispatch``'s backward gathers them instead and sums them over
the token's choices in order. Here: its ``x.grad`` against autograd of the
``index_select`` form (1e-6, f32), its bits across two calls, with drops
(capacity factor 0.5) and without (8), and the layer's gradients against
``jax.grad`` at ``tests/test_kernels.py``'s f32 TOL (2e-5). qwen3-moe-235b-
a22b's smoke config (the scatter dispatch; 4 experts, top 2) and a widened
one at top 8 of 16 experts, as the full configs choose; the reference's
layer weights and numpy inputs on both sides.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro_torch.configs import get_config
from repro_torch.models import moe

TOL = 2e-5


def _cfg(cf: float, experts: int = 0, top_k: int = 0):
    cfg = get_config("qwen3-moe-235b-a22b", smoke=True)
    m = cfg.moe
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        m, capacity_factor=cf, num_experts=experts or m.num_experts,
        top_k=top_k or m.top_k))


def _layer(cfg, seed: int):
    jp = jmoe.init_moe_mlp(jax.random.PRNGKey(seed), cfg)
    x = (0.1 * np.random.default_rng(seed).standard_normal((2, 16, cfg.d_model))
         ).astype(np.float32)
    dy = np.random.default_rng(seed + 1).standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    return jp, {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}, x, dy


def _index_select_dispatch(x2d, fill, slot):
    """The gather before ``_Dispatch``: autograd's backward is ``index_add_``."""
    zero = torch.zeros((1, x2d.shape[1]), dtype=x2d.dtype)
    return torch.cat([x2d, zero]).index_select(0, fill)


def _x_grad(tp, x, dy, cfg, dispatch=None):
    tx = torch.from_numpy(x).requires_grad_(True)
    inner = moe._Dispatch.apply
    if dispatch is not None:
        moe._Dispatch.apply = dispatch
    try:
        y, _ = moe.moe_mlp_scatter(tp, tx, cfg)
    finally:
        moe._Dispatch.apply = inner
    (g,) = torch.autograd.grad(y, tx, torch.from_numpy(dy))
    return g


SHAPES = [(0.5, 0, 0), (8.0, 0, 0), (0.5, 16, 8), (8.0, 16, 8)]


@pytest.mark.parametrize("cf,experts,top_k", SHAPES)
def test_x_grad_matches_index_select_autograd(cf, experts, top_k):
    cfg = _cfg(cf, experts, top_k)
    _, tp, x, dy = _layer(cfg, 3)
    got = _x_grad(tp, x, dy, cfg)
    want = _x_grad(tp, x, dy, cfg, _index_select_dispatch)
    assert float(want.abs().max()) > 0
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("cf,experts,top_k", SHAPES)
def test_x_grad_bits_repeat(cf, experts, top_k):
    cfg = _cfg(cf, experts, top_k)
    _, tp, x, dy = _layer(cfg, 4)
    assert torch.equal(_x_grad(tp, x, dy, cfg), _x_grad(tp, x, dy, cfg))


@pytest.mark.parametrize("cf", [0.5, 8.0])
def test_drops_reach_the_backward(cf):
    """At cf 0.5 some (token, choice) pairs drop (their slot is the drop
    slot and their gradient 0); at cf 8 none does."""
    cfg = _cfg(cf)
    _, tp, x, _ = _layer(cfg, 5)
    slots = []
    inner = moe._Dispatch.apply
    moe._Dispatch.apply = lambda x2d, fill, slot: (slots.append(slot), inner(x2d, fill, slot))[1]
    try:
        moe.moe_mlp_scatter(tp, torch.from_numpy(x), cfg)
    finally:
        moe._Dispatch.apply = inner
    B, S = x.shape[:2]
    drop = cfg.moe.num_experts * B * moe._capacity(S, cfg)
    assert bool((slots[0] == drop).any()) == (cf < 1)


def test_dispatch_backward_is_the_ordered_sum_of_each_tokens_slots():
    """``_Dispatch`` alone on hand-made indices: a token's gradient is the
    sum of its kept slots' gradients, a dropped choice adds nothing, a slot
    no token fills reaches no token."""
    T, k, d, N = 3, 2, 4, 5
    slot = torch.tensor([0, 3, 1, N, 4, 2])          # token 1's second choice drops
    fill = torch.full((N + 1,), T)
    fill.scatter_(0, slot, torch.arange(T * k) // k)
    x = torch.randn(T, d, requires_grad=True)
    out = moe._Dispatch.apply(x, fill[:-1], slot)
    torch.testing.assert_close(out, torch.cat([x, torch.zeros(1, d)])[fill[:-1]])
    dxin = torch.randn(N, d)
    (g,) = torch.autograd.grad(out, x, dxin)
    want = torch.stack([dxin[0] + dxin[3], dxin[1], dxin[4] + dxin[2]])
    assert torch.equal(g, want)


@pytest.mark.parametrize("cf,experts,top_k", SHAPES)
def test_layer_gradients_match_jax_grad(cf, experts, top_k):
    """Gradients of mean(y * dy) + 0.01 aux to every weight and to x."""
    cfg = _cfg(cf, experts, top_k)
    jp, tp, x, dy = _layer(cfg, 6)

    def jloss(p, x):
        y, aux = jmoe.moe_mlp_scatter(p, x, cfg)
        return jnp.mean(y * jnp.asarray(dy)) + 0.01 * aux

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    tp = {k: v.requires_grad_(True) for k, v in tp.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux = moe.moe_mlp_scatter(tp, tx, cfg)
    (torch.mean(y * torch.from_numpy(dy)) + 0.01 * aux).backward()
    for key in tp:
        np.testing.assert_allclose(tp[key].grad.numpy(), np.asarray(jgp[key]), atol=TOL,
                                   rtol=TOL, err_msg=key)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), atol=TOL, rtol=TOL)
