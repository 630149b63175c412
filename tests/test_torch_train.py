"""The port's backbone trainer against the JAX reference, on the CPU.

``models.model.cfm_loss`` and its gradient in every leaf against
``jax.value_and_grad`` of the reference's for the six families at their smoke
configs in f32, the noise drawn in the test as the reference's ``cfm_loss``
draws it (``split(rng, 3)``, then ``uniform``, ``normal``, ``bernoulli``);
``remat``; 3-step trajectories of ``launch.train.train`` against the
reference's ``train`` on the reference's weights (restored from a checkpoint
the reference's checkpointer wrote) and its per-step threefry draws, fresh and
resumed; the mirror of ``tests/test_models_units.py::
test_training_reduces_cfm_loss``; the in-place Adam and the layer gradients
against the forms they replace; checkpoints across the packages for all ten
archs; the launcher's flags and its refusals on the card.

Tolerance: ``tests/test_kernels.py``'s f32 TOL 2e-5, elementwise on
``|err| <= TOL (1 + |ref|)`` for the losses, and on ``|err| <= TOL
(max|ref leaf| + |ref|)`` for each gradient and param leaf (a leaf's small
entries carry the rounding of its large ones; the flow head's ``time_w1``
gradient reads up to 0.8 of it, the families alike).
"""
import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpointer as jckpt
from repro.configs import get_config as jax_get_config
from repro.core import schedulers as jsched
from repro.data.synthetic import DataConfig as JaxDataConfig
from repro.data.synthetic import SyntheticTokens as JaxSyntheticTokens
from repro.launch import train as jtrain
from repro.models import model as jmodel
from repro_torch.checkpoint import checkpointer
from repro_torch.configs import ARCHS, get_config
from repro_torch.core import schedulers as tsched
from repro_torch.launch import train as ttrain
from repro_torch.models import mamba2, moe, rwkv6, transformer, vlm, whisper
from repro_torch.models import model as M
from repro_torch.models.model import CFMNoise
from repro_torch.optim import adam

TOL = 2e-5
FAMILY_ARCH = {"dense": "yi-6b", "moe": "qwen3-moe-30b-a3b", "ssm": "rwkv6-7b",
               "hybrid": "zamba2-2.7b", "encdec": "whisper-medium", "vlm": "internvl2-26b"}
FROM_JAX = {"dense": transformer, "moe": moe, "ssm": rwkv6, "hybrid": mamba2,
            "encdec": whisper, "vlm": vlm}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Many small eager ops; beside other test workers torch's intra-op
    threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _paths(tree, prefix=()):
    """{path: leaf} of a nested dict."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_paths(v, prefix + (k,)))
        return out
    return {prefix: tree}


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close_leaves(got: dict, want: dict, what: str) -> None:
    got, want = _paths(got), _paths(want)
    assert sorted(got) == sorted(want), what
    for path, w in want.items():
        g, w = _np(got[path]).astype(np.float64), np.asarray(w, np.float64)
        assert g.shape == w.shape, (what, path)
        top = float(np.max(np.abs(w), initial=0.0))
        ratio = float(np.max(np.abs(g - w) / (TOL * (top + np.abs(w)) + 1e-30), initial=0.0))
        assert ratio <= 1.0, (what, path, ratio, top)


def _ref_noise(rng, B, S, latent_dim, p_uncond=0.1) -> CFMNoise:
    """The reference cfm_loss's draws from ``rng``, as a CFMNoise."""
    k_t, k_x0, k_drop = jax.random.split(rng, 3)
    x0 = jax.random.normal(k_x0, (B, S, latent_dim), jnp.float32)
    t = jax.random.uniform(k_t, (B,))
    drop = jax.random.bernoulli(k_drop, p_uncond, (B,))
    return CFMNoise(t=torch.from_numpy(np.array(t)), x0=torch.from_numpy(np.array(x0)),
                    drop=torch.from_numpy(np.array(drop)))


def _ref_step_noises(seed, steps, B, S, latent_dim) -> list:
    """The reference trainer's per-step draws: ``key, sub = split(key)`` a step."""
    key, out = jax.random.PRNGKey(seed), []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        out.append(_ref_noise(sub, B, S, latent_dim))
    return out


def _models(family):
    arch = FAMILY_ARCH[family]
    jcfg, cfg = jax_get_config(arch, smoke=True), get_config(arch, smoke=True)
    jparams = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    params = FROM_JAX[family].params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                              device="cpu")
    return jcfg, jparams, cfg, params


def _batch(jcfg, B=2, S=8, seed=3):
    jbatch = JaxSyntheticTokens(jcfg, JaxDataConfig(batch_size=B, seq_len=S, seed=seed)).batch(1)
    batch = {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()}
    batch["tokens"] = batch["tokens"].long()
    return jbatch, batch


def _port_loss_and_grads(params, cfg, batch, noise, remat=False):
    live = adam.tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss = M.cfm_loss(live, cfg, batch, tsched.fm_ot(), noise=noise, remat=remat)
    leaves = adam.tree_leaves(live)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    return loss, adam.tree_unflatten(live, grads)


@pytest.mark.parametrize("family", list(FAMILY_ARCH))
def test_cfm_loss_and_gradient_match_the_reference(family):
    jcfg, jparams, cfg, params = _models(family)
    jbatch, batch = _batch(jcfg)
    rng = jax.random.PRNGKey(7)
    want_loss, want_grads = jax.value_and_grad(
        lambda p: jmodel.cfm_loss(p, jcfg, jbatch, rng, jsched.fm_ot()))(jparams)
    noise = _ref_noise(rng, 2, 8, cfg.latent_dim)
    loss, grads = _port_loss_and_grads(params, cfg, batch, noise)
    assert abs(float(loss.detach()) - float(want_loss)) <= TOL * (1 + abs(float(want_loss)))
    _close_leaves(grads, jax.tree.map(np.asarray, want_grads), family)


def test_cfm_loss_drop_zeroes_the_conditioning():
    """A dropped row sees the zero token's conditioning, as the reference's."""
    _, _, cfg, params = _models("dense")
    _, batch = _batch(jax_get_config("yi-6b", smoke=True))
    noise = M.draw_cfm_noise(torch.Generator().manual_seed(0), 2, 8, cfg.latent_dim)
    all_drop = noise._replace(drop=torch.ones(2, dtype=torch.bool))
    zeroed = {**batch, "tokens": torch.zeros_like(batch["tokens"])}
    # the targets x1 come from the data tokens either way; only the
    # conditioning differs, so a dropped batch equals a batch whose
    # conditioning is zero but whose targets are unchanged
    with torch.no_grad():
        got = M.cfm_loss(params, cfg, batch, tsched.fm_ot(), noise=all_drop)
        x1 = M.latent_targets(params, batch["tokens"]).float()
        tb = all_drop.t[:, None, None]
        sched = tsched.fm_ot()
        x_t = sched.sigma(tb) * all_drop.x0 + sched.alpha(tb) * x1
        target = sched.dsigma(tb) * all_drop.x0 + sched.dalpha(tb) * x1
        v = M.velocity(params, cfg, all_drop.t, x_t, zeroed)
        want = torch.mean((v - target) ** 2)
    assert torch.equal(got, want)


@pytest.mark.parametrize("family", list(FAMILY_ARCH))
def test_remat_changes_no_bit(family):
    _, _, cfg, params = _models(family)
    _, batch = _batch(jax_get_config(FAMILY_ARCH[family], smoke=True))
    noise = M.draw_cfm_noise(torch.Generator().manual_seed(1), 2, 8, cfg.latent_dim, 0.5)
    plain = _port_loss_and_grads(params, cfg, batch, noise)
    remat = _port_loss_and_grads(params, cfg, batch, noise, remat=True)
    assert torch.equal(plain[0], remat[0])
    for a, b in zip(adam.tree_leaves(plain[1]), adam.tree_leaves(remat[1])):
        assert torch.equal(a, b)


def test_cfm_loss_draws_from_a_generator_as_draw_cfm_noise():
    """``noise`` may be a generator, as the reference's rng argument: the
    same loss as the draws ``draw_cfm_noise`` makes from it."""
    _, _, cfg, params = _models("dense")
    _, batch = _batch(jax_get_config("yi-6b", smoke=True))
    with torch.no_grad():
        got = M.cfm_loss(params, cfg, batch, tsched.fm_ot(),
                         noise=torch.Generator().manual_seed(4), p_uncond=0.5)
        want = M.cfm_loss(params, cfg, batch, tsched.fm_ot(), noise=M.draw_cfm_noise(
            torch.Generator().manual_seed(4), 2, 8, cfg.latent_dim, 0.5))
    assert torch.equal(got, want)


def test_draw_cfm_noise_shapes_and_order():
    g = torch.Generator().manual_seed(5)
    n = M.draw_cfm_noise(g, 3, 4, 6, p_uncond=0.5)
    g2 = torch.Generator().manual_seed(5)
    assert torch.equal(n.t, torch.rand((3,), generator=g2))
    assert torch.equal(n.x0, torch.randn((3, 4, 6), generator=g2))
    assert torch.equal(n.drop, torch.rand((3,), generator=g2) < 0.5)
    assert n.t.dtype == n.x0.dtype == torch.float32 and n.drop.dtype == torch.bool


def _write_ref_init(arch, dirs, step):
    """The reference's seed-0 weights as ``step_<step>`` in each of ``dirs``."""
    jparams = jmodel.init_params(jax.random.PRNGKey(0), jax_get_config(arch, smoke=True))
    for d in dirs:
        jckpt.save(jckpt.step_path(d, step), jparams)


@pytest.mark.parametrize("arch", ["yi-6b", "qwen3-moe-30b-a3b"])
def test_three_steps_match_the_reference_trainer(arch, tmp_path):
    """The reference's weights restored in both trainers (step 0 of the
    checkpoint directory, so both start at step 0), the reference's per-step
    draws fed to the port: the losses and the final params within TOL."""
    B, S, steps = 4, 16, 3
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    _write_ref_init(arch, (jdir, tdir), 0)
    want_params, want_losses = jtrain.train(arch, smoke=True, steps=steps, batch=B, seq=S,
                                            ckpt_dir=jdir, log=lambda *_: None)
    cfg = get_config(arch, smoke=True)
    noises = _ref_step_noises(0, steps, B, S, cfg.latent_dim)
    run = ttrain.train(arch, smoke=True, steps=steps, batch=B, seq=S, ckpt_dir=tdir,
                       device="cpu", noise_source=lambda step: noises[step],
                       log=lambda *_: None)
    assert run.start == 0 and len(run.losses) == steps
    for got, want in zip(run.losses, want_losses):
        assert abs(got - want) <= TOL * (1 + abs(want)), (run.losses, want_losses)
    _close_leaves(run.params, jax.tree.map(np.asarray, want_params), arch)
    assert int(run.opt.step) == steps


def test_resume_restarts_adam_as_the_reference_does(tmp_path):
    """A checkpoint at step 1: both trainers restore the params only, Adam
    from zero (its first resumed step at rate 0 again), the noise stream from
    the seed's start; both save at their last step (--ckpt-every 3)."""
    arch, B, S, steps = "yi-6b", 4, 16, 3
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    _write_ref_init(arch, (jdir, tdir), 1)
    logs = []
    want_params, want_losses = jtrain.train(arch, smoke=True, steps=steps, batch=B, seq=S,
                                            ckpt_dir=jdir, ckpt_every=3, log=logs.append)
    cfg = get_config(arch, smoke=True)
    noises = _ref_step_noises(0, steps, B, S, cfg.latent_dim)
    run = ttrain.train(arch, smoke=True, steps=steps, batch=B, seq=S, ckpt_dir=tdir,
                       ckpt_every=3, device="cpu",
                       noise_source=lambda step: noises[step - 1], log=logs.append)
    assert run.start == 1 and int(run.opt.step) == 2 and len(run.losses) == 2
    assert logs.count(f"restored step 1 from {jdir}") == 1
    assert logs.count(f"restored step 1 from {tdir}") == 1
    for got, want in zip(run.losses, want_losses):
        assert abs(got - want) <= TOL * (1 + abs(want)), (run.losses, want_losses)
    _close_leaves(run.params, jax.tree.map(np.asarray, want_params), "resumed")
    assert checkpointer.latest_step(tdir) == jckpt.latest_step(jdir) == 3
    saved = checkpointer.restore(checkpointer.step_path(tdir, 3), run.params)
    for a, b in zip(adam.tree_leaves(saved), adam.tree_leaves(run.params)):
        assert torch.equal(a, b)
    # the reference restores the port's file, and the port the reference's
    jsaved = jckpt.restore(jckpt.step_path(tdir, 3), want_params)
    _close_leaves(run.params, jax.tree.map(np.asarray, jsaved), "port file in the reference")


def test_training_reduces_cfm_loss():
    """``tests/test_models_units.py::test_training_reduces_cfm_loss`` for the
    port's trainer: 30 steps must reduce the CFM loss by 10%."""
    run = ttrain.train("yi-6b", smoke=True, steps=30, batch=8, seq=16, lr=3e-3,
                       device="cpu", log=lambda *_: None)
    losses = run.losses
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) * 0.9, losses[:3] + losses[-3:]
    assert len(run.trainer.programs) == 0          # eager on the CPU: nothing captured


def test_rates_start_at_zero_and_follow_warmup_cosine():
    """The trainer's rate at Adam's count i is ``warmup_cosine(lr, max(steps //
    10, 1), steps)(i)``, the reference's, read before the count goes up."""
    from repro.optim import warmup_cosine as jwarmup

    from repro_torch.optim.schedule import schedule_table, warmup_cosine

    steps, lr = 25, 3e-4
    got = schedule_table(warmup_cosine(lr, 2, steps), steps, "cpu")
    want = np.array([float(jwarmup(lr, 2, steps)(jnp.asarray(i, jnp.int32)))
                     for i in range(steps)], np.float32)
    assert got[0] == 0.0
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# The in-place Adam and the layer gradients against the forms they replace
# ---------------------------------------------------------------------------


def _adam_tree(seed):
    g = torch.Generator().manual_seed(seed)
    return {"layers": {"w": torch.randn((4, 8, 16), generator=g),        # a stacked leaf
                       "norm": torch.randn((4, 8), generator=g).to(torch.bfloat16)},
            "embed": torch.randn((10, 16), generator=g), "scale": torch.randn((), generator=g)}


def _old_adam_update(grads, state, params, lr, *, weight_decay, grad_clip_norm,
                     b1=0.9, b2=0.999, eps=1e-8):
    """``adam_update`` as it was written before the slices: one f32 sum of
    squares a leaf."""
    step = state.step + 1
    gnorm = torch.sqrt(sum(torch.sum(g.to(torch.float32) ** 2)
                           for g in adam.tree_leaves(grads)))
    scale = torch.clamp(grad_clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    grads = adam.tree_map(lambda g: g * scale, grads)
    mu = adam.tree_map(lambda m, g: b1 * m + (1 - b1) * g.to(m.dtype), state.mu, grads)
    nu = adam.tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(g.to(v.dtype)),
                       state.nu, grads)
    bc1 = 1 - b1 ** step.to(torch.float32)
    bc2 = 1 - b2 ** step.to(torch.float32)

    def upd(p, m, v):
        update = (m / bc1) / (torch.sqrt(v / bc2) + eps) + weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - lr * update).to(p.dtype)

    return adam.tree_map(upd, params, mu, nu), adam.AdamState(step=step, mu=mu, nu=nu)


def _adam_steps(update_fn, params, state, steps=3):
    """``steps`` updates of ``params`` by ``update_fn(grads, state, params,
    lr)`` (returning the new pair, or None in place), under no_grad."""
    rates = torch.tensor([1e-2, 2e-2, 3e-2])
    for k in range(steps):
        grads = adam.tree_map(lambda p: (p.float() * (k + 2)).to(p.dtype) ** 2,
                              _adam_tree(k + 1))
        with torch.no_grad():
            out = update_fn(grads, state, params, rates[k])
        if out is not None:
            params, state = out
    return params, state


def _update_(grads, state, params, lr):
    adam.adam_update_(grads, state, params, lr, weight_decay=0.01, grad_clip_norm=1.0)


@pytest.mark.parametrize("slice_elems", [adam.SLICE["cpu"], 100, 1])
def test_in_place_adam_equals_adam_update_to_the_bit(slice_elems, monkeypatch):
    """Three steps of ``adam_update_`` (in place, a slice at a time) against
    ``adam_update``, weight decay and clipping on, with the CPU's slice size
    at its default (one slice a leaf here), at 100 elements (slices across
    the stacked leaf's rows) and at 1: params, moments and step equal to the
    bit, every leaf at its address."""
    monkeypatch.setitem(adam.SLICE, "cpu", slice_elems)
    params = _adam_tree(0)
    want = _adam_steps(lambda g, s, p, lr: adam.adam_update(
        g, s, p, lr, weight_decay=0.01, grad_clip_norm=1.0), params, adam.adam_init(params))
    mine = adam.tree_map(torch.clone, params)
    state = adam.adam_init(mine)
    addresses = [x.data_ptr() for x in adam.tree_leaves((mine, state))]
    got = _adam_steps(_update_, mine, state)
    for a, b in zip(adam.tree_leaves(want), adam.tree_leaves(got)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert [x.data_ptr() for x in adam.tree_leaves(got)] == addresses


def test_in_place_adam_equals_the_unsliced_form_to_the_bit():
    """At the default slice size the solvers' small trees take one slice a
    leaf, so ``adam_update_`` equals the form written before the slices
    (one f32 sum of squares a leaf, whole-leaf arithmetic), and so does
    ``adamw``'s closure at the same rates."""
    params = _adam_tree(0)
    want = _adam_steps(lambda g, s, p, lr: _old_adam_update(
        g, s, p, lr, weight_decay=0.01, grad_clip_norm=1.0), params, adam.adam_init(params))
    mine = adam.tree_map(torch.clone, params)
    got = _adam_steps(_update_, mine, adam.adam_init(mine))
    rates = torch.tensor([1e-2, 2e-2, 3e-2])
    init, update = adam.adamw(lambda step: rates[int(step)], weight_decay=0.01,
                              grad_clip_norm=1.0)
    closure = _adam_steps(lambda g, s, p, lr: update(g, s, p), params, init(params))
    for a, b, c in zip(adam.tree_leaves(want), adam.tree_leaves(got),
                       adam.tree_leaves(closure)):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.parametrize("slice_elems", [adam.SLICE["cpu"], 8, 16 * 8])
def test_in_place_adam_takes_gradients_as_rows(slice_elems, monkeypatch):
    """The stacked leaf's gradient given as its 4 rows (as the trainer takes
    it): ``adam_update_`` equals ``adam_update`` on the same rows to the bit,
    at the default slice size, at 8 elements (each row in slices) and at one
    row (16 x 8) a slice, where the stacked form slices the same way and so
    equals it too."""
    monkeypatch.setitem(adam.SLICE, "cpu", slice_elems)

    def rows(grads):
        layers = {**grads["layers"], "w": tuple(grads["layers"]["w"].unbind(0))}
        return {**grads, "layers": layers}

    params = _adam_tree(0)
    want = _adam_steps(lambda g, s, p, lr: adam.adam_update(
        rows(g), s, p, lr, weight_decay=0.01, grad_clip_norm=1.0), params,
        adam.adam_init(params))
    mine = adam.tree_map(torch.clone, params)
    got = _adam_steps(lambda g, s, p, lr: _update_(rows(g), s, p, lr), mine,
                      adam.adam_init(mine))
    for a, b in zip(adam.tree_leaves(want), adam.tree_leaves(got)):
        assert torch.equal(a, b)
    if slice_elems == 16 * 8:
        stacked = adam.tree_map(torch.clone, params)
        also = _adam_steps(_update_, stacked, adam.adam_init(stacked))
        for a, b in zip(adam.tree_leaves(want), adam.tree_leaves(also)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("family", list(FAMILY_ARCH))
def test_unbound_layers_give_each_layer_its_gradient_bit_for_bit(family):
    """``model.unbind_layers`` (the trainer's form): the loss and each
    layer's gradient equal, to the bit, the rows of the stacked leaf's
    gradient through ``x[i]`` layer by layer."""
    _, _, cfg, params = _models(family)
    _, batch = _batch(jax_get_config(FAMILY_ARCH[family], smoke=True))
    noise = M.draw_cfm_noise(torch.Generator().manual_seed(3), 2, 8, cfg.latent_dim, 0.5)
    stacked_loss, stacked = _port_loss_and_grads(params, cfg, batch, noise)
    live = M.unbind_layers(adam.tree_map(lambda p: p.detach().requires_grad_(True), params))
    loss = M.cfm_loss(live, cfg, batch, tsched.fm_ot(), noise=noise)
    leaves = adam.tree_leaves(live)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    assert torch.equal(loss, stacked_loss)
    assert len(leaves) > len(adam.tree_leaves(params))
    got = adam._grad_leaves(adam.tree_unflatten(live, grads), params)
    for g, want in zip(got, adam.tree_leaves(stacked)):
        assert torch.equal(g if isinstance(g, torch.Tensor) else torch.stack(g), want)


@pytest.mark.parametrize("family", list(FAMILY_ARCH))
def test_layer_views_index_stacked_and_unbound_leaves_alike(family):
    """Every stacked subtree of the family's params gives, through
    ``layer_views``, one tree a layer whose leaves are the same views of
    the same storage whether the subtree holds the stacked tensors or
    ``unbind_layers``' tuples; no view of a leaf that needs no grad carries
    a graph."""
    _, _, cfg, params = _models(family)
    unbound = M.unbind_layers(params)
    stacks = [k for k in M.LAYER_STACKS if k in params]
    assert stacks
    for key in stacks:
        from_stack = transformer.layer_views(params[key])
        from_tuples = transformer.layer_views(unbound[key])
        assert len(from_stack) == len(from_tuples) == len(adam.tree_leaves(params[key])[0])
        for a, b in zip(from_stack, from_tuples):
            for x, y in zip(adam.tree_leaves(a), adam.tree_leaves(b)):
                assert x.shape == y.shape and x.data_ptr() == y.data_ptr()
                assert x.stride() == y.stride() and torch.equal(x, y)
                assert x.grad_fn is None


# ---------------------------------------------------------------------------
# Checkpoints across the packages
# ---------------------------------------------------------------------------


def _port_init(arch, seed=0):
    cfg = get_config(arch, smoke=True)
    return M.init_params(torch.Generator().manual_seed(seed), cfg, "cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_checkpoint_restores_in_the_port_to_the_bit(arch, tmp_path):
    """The reference's weights, saved by its checkpointer, restored into the
    port's own param tree (its template): every leaf equal to the bit, in
    the template leaf's dtype and shape; the port saving them again writes
    the reference's bytes."""
    jparams = jmodel.init_params(jax.random.PRNGKey(0), jax_get_config(arch, smoke=True))
    path = str(tmp_path / "ref.msgpack")
    jckpt.save(path, jparams)
    template = _port_init(arch, seed=1)
    restored = checkpointer.restore(path, template, device="cpu")
    want, got, tmpl = _paths(jax.tree.map(np.asarray, jparams)), _paths(restored), \
        _paths(template)
    assert sorted(got) == sorted(want) == sorted(tmpl)
    for k, w in want.items():
        assert got[k].dtype == tmpl[k].dtype and tuple(got[k].shape) == w.shape, k
        assert np.array_equal(got[k].numpy(), w), k
    again = str(tmp_path / "port.msgpack")
    checkpointer.save(again, restored)
    with open(path, "rb") as a, open(again, "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("arch", ARCHS)
def test_port_checkpoint_restores_in_the_reference_to_the_bit(arch, tmp_path):
    """The port's weights, saved by its checkpointer, restored by the
    reference's onto its own param tree: the same paths, shapes and dtypes,
    every leaf equal to the bit."""
    params = _port_init(arch)
    path = str(tmp_path / "port.msgpack")
    checkpointer.save(path, params)
    jtemplate = jmodel.init_params(jax.random.PRNGKey(1), jax_get_config(arch, smoke=True))
    restored = jckpt.restore(path, jtemplate)
    got, want, tmpl = (_paths(jax.tree.map(np.asarray, restored)), _paths(params),
                       _paths(jax.tree.map(np.asarray, jtemplate)))
    assert sorted(got) == sorted(want) == sorted(tmpl)
    for k, w in want.items():
        assert got[k].shape == tmpl[k].shape == tuple(w.shape), k
        assert got[k].dtype == tmpl[k].dtype, k
        assert np.array_equal(got[k], w.numpy()), k


@pytest.mark.parametrize("arch", ["yi-6b", "qwen3-moe-30b-a3b"])
def test_bf16_checkpoints_cross_as_the_reference_writes_them(arch, tmp_path):
    """A bf16 tree (the full configs' dtype): the reference writes each bf16
    leaf as its numpy names it (``<V2``, the raw 2-byte values); the port
    restores that file to the bit, in bf16, and writes the same bytes. The
    reference's own ``restore`` refuses the dtype (JAX takes no void arrays):
    a bf16 tree restores only in the port."""
    from repro_torch.models.transformer import _from_numpy

    jcfg = jax_get_config(arch, smoke=True)
    jparams = jmodel.init_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.bfloat16)
    path = str(tmp_path / "ref.msgpack")
    jckpt.save(path, jparams)
    template = M.init_params(torch.Generator().manual_seed(1),
                             dataclasses.replace(get_config(arch, smoke=True),
                                                 dtype="bfloat16"), "cpu")
    restored = checkpointer.restore(path, template)
    want = _paths(jax.tree.map(np.asarray, jparams))
    for k, got in _paths(restored).items():
        assert got.dtype == _paths(template)[k].dtype, k
        assert torch.equal(got, _from_numpy(want[k]).to(got.dtype)), k
    assert sum(1 for t in adam.tree_leaves(restored) if t.dtype == torch.bfloat16) > 0
    again = str(tmp_path / "port.msgpack")
    checkpointer.save(again, restored)
    with open(path, "rb") as a, open(again, "rb") as b:
        assert a.read() == b.read()
    with pytest.raises(TypeError):
        jckpt.restore(again, jparams)


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------


def _reference_flags(monkeypatch, argv) -> tuple[set, dict]:
    """The option strings of the reference's ``train.main`` parser and the
    keywords it hands ``train`` for ``argv``."""
    seen, parsers = {}, []
    inner = argparse.ArgumentParser.parse_args

    def spy(self, args=None, namespace=None):
        parsers.append(self)
        return inner(self, args, namespace)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", spy)
    monkeypatch.setattr(jtrain, "train", lambda arch, **kw: seen.update(arch=arch, **kw))
    monkeypatch.setattr("sys.argv", ["train"] + argv)
    jtrain.main()
    return ({s for a in parsers[0]._actions for s in a.option_strings} - {"-h", "--help"},
            seen)


def test_parser_takes_every_reference_flag(monkeypatch):
    argv = ["--arch", "qwen3-moe-30b-a3b", "--smoke", "--steps", "7", "--batch", "3",
            "--seq", "5", "--lr", "0.01", "--scheduler", "vp", "--ckpt-dir", "d",
            "--seed", "4"]
    ref, kw = _reference_flags(monkeypatch, argv)
    port = ttrain.build_parser()
    ours = {s for a in port._actions for s in a.option_strings}
    assert ref <= ours, sorted(ref - ours)
    assert {"--device", "--layers", "--ckpt-every"} <= ours
    args = vars(port.parse_args(argv))
    for dest, value in kw.items():
        assert args[dest] == value, dest
    assert args["device"] == "cuda" and args["layers"] is None and args["ckpt_every"] == 50


@pytest.mark.parametrize("arch,items", [
    ("rwkv6-7b", ["ROADMAP Queue B item 6"]),
    ("zamba2-2.7b", ["ROADMAP Queue B item 6", "ROADMAP Queue B item 7"]),
    ("whisper-medium", ["ROADMAP Queue B item 7"]),
])
def test_card_refuses_the_families_without_a_backward(arch, items):
    """Before any device is touched (this machine has no card), naming the
    backward each family lacks; the CPU trains them."""
    with pytest.raises(SystemExit) as exc:
        ttrain.main(["--arch", arch, "--smoke", "--steps", "1", "--device", "cuda"])
    text = str(exc.value.code)
    assert arch in text and "--device cpu" in text
    for item in items:
        assert item in text


def test_card_without_a_card_exits_naming_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit) as exc:
        ttrain.main(["--arch", "yi-6b", "--smoke", "--steps", "1"])
    assert "device='cpu'" in str(exc.value.code)


@pytest.mark.parametrize("family", [f for f in FAMILY_ARCH if f != "dense"])
def test_every_other_family_trains_on_the_cpu(family, tmp_path):
    """Two steps of ``main`` on the CPU, a checkpoint at the second; finite losses."""
    arch = FAMILY_ARCH[family]
    run = ttrain.main(["--arch", arch, "--smoke", "--steps", "2", "--batch", "2", "--seq",
                       "8", "--device", "cpu", "--ckpt-dir", str(tmp_path),
                       "--ckpt-every", "2"])
    assert len(run.losses) == 2 and all(np.isfinite(run.losses))
    assert checkpointer.latest_step(str(tmp_path)) == 2


@pytest.mark.parametrize("arch", ARCHS)
def test_param_template_matches_init_params_leaf_for_leaf(arch):
    """``param_template``'s tree has ``init_params``' structure, shapes and
    dtypes (what ``restore`` reads of a template), and no leaf has storage."""
    from torch._subclasses.fake_tensor import FakeTensor

    cfg = get_config(arch, smoke=True)
    template = M.param_template(cfg)
    real = M.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    assert sorted(_paths(template)) == sorted(_paths(real))
    for path, leaf in _paths(real).items():
        fake = _paths(template)[path]
        assert isinstance(fake, FakeTensor) and type(leaf) is torch.Tensor, path
        assert (fake.shape, fake.dtype) == (leaf.shape, leaf.dtype), path


def test_param_template_of_a_full_config_allocates_nothing():
    """yi-34b's full tree (~68.8 GB of bf16 weights) as a template: the
    process's resident memory grows by far less than one of its layers."""
    import resource

    def rss():
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * resource.getpagesize()

    before = rss()
    template = M.param_template(get_config("yi-34b"))
    grown = rss() - before
    nbytes = sum(p.numel() * p.element_size() for p in adam.tree_leaves(template))
    assert nbytes > 68e9 and grown < 256 * 2**20, (nbytes, grown)


def test_resume_restores_into_the_template_and_draws_no_weights(tmp_path, monkeypatch):
    """A resumed run restores the checkpoint into ``param_template`` (its
    params on the device once): it never draws random weights, and its
    params are the checkpoint's, as real tensors."""
    from torch._subclasses.fake_tensor import FakeTensor

    tree_leaves = adam.tree_leaves
    first = ttrain.main(["--arch", "yi-6b", "--smoke", "--steps", "1", "--batch", "2",
                         "--seq", "4", "--device", "cpu", "--ckpt-dir", str(tmp_path),
                         "--ckpt-every", "1", "--lr", "0"])

    init_params = M.init_params

    def drawn(*args):
        tree = init_params(*args)
        assert all(isinstance(x, FakeTensor) for x in tree_leaves(tree)), \
            "random weights drawn on resume"
        return tree

    monkeypatch.setattr(ttrain.M, "init_params", drawn)
    resumed = ttrain.main(["--arch", "yi-6b", "--smoke", "--steps", "2", "--batch", "2",
                           "--seq", "4", "--device", "cpu", "--ckpt-dir", str(tmp_path),
                           "--lr", "0"])
    assert resumed.start == 1 and len(resumed.losses) == 1
    for a, b in zip(adam.tree_leaves(resumed.params), adam.tree_leaves(first.params)):
        assert type(a) is torch.Tensor and torch.equal(a, b)


def test_train_state_bytes_of_yi_6b():
    """yi-6b's 6,099,210,240 params: bf16 params and gradients and f32
    moments, 12 bytes each, the f32 final norm 16."""
    n = 32 * (2 * 4096 * 4096 + 2 * 4096 * 512 + 3 * 4096 * 11008 + 2 * 4096) \
        + 2 * 64000 * 4096 + 4096 + 64000 * 64 + 2 * 64 * 4096 + 2 * 4096 * 4096
    assert n == 6_099_210_240
    assert ttrain.train_state_bytes(get_config("yi-6b")) == 12 * (n - 4096) + 16 * 4096


def test_main_at_a_cut_depth_keeps_the_width():
    run = ttrain.main(["--arch", "yi-6b", "--smoke", "--steps", "1", "--batch", "2", "--seq",
                       "4", "--device", "cpu", "--layers", "1"])
    assert run.params["layers"]["attn"]["wq"].shape[0] == 1
    assert run.params["embed"].shape == (256, 256)
