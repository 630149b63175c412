"""The port's MoE family (qwen3-moe-30b-a3b, qwen3-moe-235b-a22b) against the
JAX reference, on the CPU.

The two smoke configs (2 layers, d_model 128, 4 experts, top 2, f32): the
30b-a3b one dispatches through ``onehot`` (capacity over the global batch,
factor 1.25), the 235b-a22b one through ``scatter`` (capacity per sequence),
so each dispatch path meets its oracle. The reference's params from
``init_params(PRNGKey(0), cfg)`` go to both sides as numpy, with the norms
redrawn so they are live; inputs, tokens and noise are made with numpy from a
seed. Tolerances are ``tests/test_kernels.py``'s TOL (f32 2e-5, bf16 2e-2),
times NFE for a sampler's accumulated sum and times 4 through attention, as
the decode tests scale them; expert choices are compared for equality.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import schedulers as jsched
from repro.kernels.flash_attention.paged_attention import paged_attention as jax_paged
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro.serving import decode as jdecode
from repro.serving import engine as jengine
from repro.serving.engine import FlowSampler as JaxFlowSampler
from repro.solvers import registry as jreg
from repro_torch.configs import get_config
from repro_torch.core import schedulers as tsched
from repro_torch.kernels.flash_attention import flash_attention as fa_mod
from repro_torch.kernels.flash_attention import paged_attention as pa_mod
from repro_torch.kernels.flash_attention.ops import paged_attend
from repro_torch.kernels.flash_attention.ref import paged_attention_ref
from repro_torch.kernels.ns_update import ns_update as nu_mod
from repro_torch.launch import serve
from repro_torch.models import model as tmodel
from repro_torch.models.attention import KVCache
from repro_torch.models import moe
from repro_torch.serving import programs
from repro_torch.serving.decode import DecodeGateway, DecodeRequest
from repro_torch.serving.engine import DecodeEngine, FlowSampler, SlotSampling
from repro_torch.solvers import registry as treg
from torch_graph_double import CPUGraph

TOL = {"float32": 2e-5, "bfloat16": 2e-2}     # tests/test_kernels.py
ARCHS = ("qwen3-moe-30b-a3b", "qwen3-moe-235b-a22b")
KERNELS = (fa_mod.COUNTER, pa_mod.COUNTER, nu_mod.COUNTER)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol=TOL["float32"], **kw):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol, **kw)


def _rand(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _tokens(seed, B, S, vocab):
    return np.random.default_rng(seed).integers(0, vocab, size=(B, S))


def _launches():
    return tuple(c.launches for c in KERNELS)


def _live(tree: dict, seed: int) -> dict:
    """The reference tree (numpy) with the norms redrawn around 1."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.array, tree)
    for key in ("norm1", "norm2"):
        leaf = tree["layers"][key]
        tree["layers"][key] = (1.0 + 0.1 * rng.standard_normal(leaf.shape)).astype(leaf.dtype)
    return tree


def _models(arch):
    jcfg = jax_get_config(arch, smoke=True)
    tree = _live(jmodel.init_params(jax.random.PRNGKey(0), jcfg), 0)
    cfg = get_config(arch, smoke=True)
    return jcfg, jax.tree.map(jnp.asarray, tree), cfg, moe.params_from_jax(tree, cfg, "cpu")


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    return _models(request.param)


@pytest.fixture(scope="module")
def onehot_models():
    return _models("qwen3-moe-30b-a3b")


def _mlp(seed, cfg):
    """One layer's router and experts (the reference's init), both sides."""
    jp = jmoe.init_moe_mlp(jax.random.PRNGKey(seed), cfg)
    return jp, {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}


def _with_cf(cfg, cf=None, impl=None):
    m = cfg.moe
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        m, capacity_factor=m.capacity_factor if cf is None else cf,
        router_impl=impl or m.router_impl))


# -- configs -----------------------------------------------------------------


@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_is_the_reference_config(arch, smoke):
    assert dataclasses.asdict(get_config(arch, smoke=smoke)) == \
        dataclasses.asdict(jax_get_config(arch, smoke=smoke))
    assert get_config(arch, smoke=smoke).param_count() == \
        jax_get_config(arch, smoke=smoke).param_count()


def test_smoke_configs_cover_both_dispatch_paths():
    a, b = (get_config(arch, smoke=True).moe for arch in ARCHS)
    assert (a.router_impl, a.capacity_factor) == ("onehot", 1.25)
    assert (b.router_impl, b.capacity_factor) == ("scatter", 1.25)
    for arch in ARCHS:
        assert get_config(arch).moe.router_impl == "scatter"


def test_params_from_jax_takes_only_the_moe_tree(onehot_models):
    jcfg, jparams, cfg, _ = onehot_models
    tree = jax.tree.map(np.asarray, jparams)
    bad = dict(tree, layers={k: v for k, v in tree["layers"].items() if k != "moe"})
    with pytest.raises(ValueError, match="layer tree"):
        moe.params_from_jax(bad, cfg, "cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_init_moe_params_has_the_reference_tree(arch, dtype):
    """The port's initializer gives the reference's leaves: names, shapes and
    dtypes (``cast_params``' rule: stacked leaves take the dtype, the final
    norm stays f32)."""
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=dtype)
    jcfg = dataclasses.replace(jax_get_config(arch, smoke=True), dtype=dtype)
    got = tmodel.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    want = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    flat_got = dict(_flatten(got))
    flat_want = dict(_flatten(jax.tree.map(np.asarray, want)))
    assert flat_got.keys() == flat_want.keys()
    for k, v in flat_want.items():
        assert tuple(flat_got[k].shape) == v.shape, k
        assert str(flat_got[k].dtype)[6:] == str(v.dtype), k


def _flatten(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + k + ".")
        else:
            yield prefix + k, v


# -- routing and dispatch ----------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_routing_matches_the_reference(arch):
    """Gates, expert indices (equal, in the reference's order) and the
    Switch aux loss."""
    cfg = get_config(arch, smoke=True)
    jp, tp = _mlp(3, cfg)
    x = _rand(4, (64, cfg.d_model), 0.1)
    jg, ji, ja = jmoe._routing(jp, jnp.asarray(x), cfg)
    tg, ti, ta = moe._routing(tp, torch.from_numpy(x), cfg)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _close(tg, jg)
    _close(ta, ja)


def test_routing_breaks_ties_toward_the_lower_expert():
    """Equal router probabilities: the lower expert comes first, as
    ``jax.lax.top_k`` orders them."""
    cfg = get_config("qwen3-moe-235b-a22b", smoke=True)
    E = cfg.moe.num_experts
    router = np.zeros((cfg.d_model, E), np.float32)
    router[0] = [0.0, 1.0, 1.0, 0.0][:E]          # experts 1 and 2 tie, then 0 and 3
    x = np.zeros((3, cfg.d_model), np.float32)
    x[:, 0] = [1.0, 0.0, -1.0]
    _, ti, _ = moe._routing({"router": torch.from_numpy(router)}, torch.from_numpy(x), cfg)
    _, ji, _ = jmoe._routing({"router": jnp.asarray(router)}, jnp.asarray(x), cfg)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert ti.tolist() == [[1, 2], [0, 1], [0, 3]]


@pytest.mark.parametrize("cf", [None, 0.25, 8.0])
@pytest.mark.parametrize("impl", ["scatter", "onehot"])
@pytest.mark.parametrize("arch", ARCHS)
def test_dispatch_matches_the_reference(arch, impl, cf):
    """``moe_mlp_scatter`` and ``moe_mlp_onehot`` against the reference's at
    the config's capacity factor, 0.25 (tokens dropped) and 8.0 (none):
    outputs and aux loss (tests/test_models_units.py's cases, held to the
    reference)."""
    cfg = _with_cf(get_config(arch, smoke=True), cf)
    jp, tp = _mlp(0, cfg)
    x = _rand(1, (2, 32, cfg.d_model), 0.1)
    jfn = jmoe.moe_mlp_scatter if impl == "scatter" else jmoe.moe_mlp_onehot
    tfn = moe.moe_mlp_scatter if impl == "scatter" else moe.moe_mlp_onehot
    jy, ja = jfn(jp, jnp.asarray(x), cfg)
    ty, ta = tfn(tp, torch.from_numpy(x), cfg)
    assert ty.shape == x.shape and ty.dtype == torch.float32
    _close(ty, jy)
    _close(ta, ja)


@pytest.mark.parametrize("arch", ARCHS)
def test_dispatch_matches_the_reference_in_bf16(arch):
    """bf16 x and weights at the config's capacity: expert choices equal,
    outputs within the bf16 TOL."""
    cfg = get_config(arch, smoke=True)
    jp, _ = _mlp(5, cfg)
    jp = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp)
    tp = {k: torch.from_numpy(np.array(v.astype(jnp.float32))).to(torch.bfloat16)
          for k, v in jp.items()}
    x = _rand(6, (2, 32, cfg.d_model), 0.1)
    jx, tx = jnp.asarray(x).astype(jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
    _, ji, _ = jmoe._routing(jp, jx.reshape(-1, cfg.d_model), cfg)
    _, ti, _ = moe._routing(tp, tx.reshape(-1, cfg.d_model), cfg)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    jy, _ = jmoe.moe_mlp(jp, jx, cfg)
    ty, _ = moe.moe_mlp(tp, tx, cfg)
    assert ty.dtype == torch.bfloat16
    _close(ty, jy, TOL["bfloat16"])


def test_scatter_matches_onehot_when_nothing_is_dropped():
    cfg = _with_cf(get_config("qwen3-moe-30b-a3b", smoke=True), 8.0)
    _, tp = _mlp(0, cfg)
    x = torch.from_numpy(_rand(1, (2, 16, cfg.d_model), 0.1))
    y1, a1 = moe.moe_mlp_scatter(tp, x, cfg)
    y2, a2 = moe.moe_mlp_onehot(tp, x, cfg)
    _close(y1, y2, 1e-5)
    _close(a1, a2, 1e-5)


def test_capacity_drops_tokens():
    """capacity_factor 0.25 drops tokens: the output moves off the no-drop
    one and stays finite."""
    cfg = get_config("qwen3-moe-30b-a3b", smoke=True)
    _, tp = _mlp(0, cfg)
    x = torch.from_numpy(_rand(1, (2, 32, cfg.d_model), 0.1))
    tight, _ = moe.moe_mlp_scatter(tp, x, _with_cf(cfg, 0.25))
    loose, _ = moe.moe_mlp_scatter(tp, x, _with_cf(cfg, 8.0))
    assert bool(torch.isfinite(tight).all())
    assert float((tight - loose).abs().max()) > 1e-4


@pytest.mark.parametrize("T,cf,want", [(32, 1.25, 20), (1, 1.0, 2), (7, 0.25, 2),
                                       (1024, 1.0, 512)])
def test_capacity_rule(T, cf, want):
    cfg = _with_cf(get_config("qwen3-moe-30b-a3b", smoke=True), cf)
    assert moe._capacity(T, cfg) == jmoe._capacity(T, cfg) == want


def test_full_width_capacity_in_decode_and_flow():
    """At S = 1 a sequence's capacity is k = 8 slots an expert (the decode
    step's (B, 128, 8, d) buffer); at S = 1024 it is 64."""
    cfg = get_config("qwen3-moe-30b-a3b")
    assert (moe._capacity(1, cfg), moe._capacity(1024, cfg)) == (8, 64)


@pytest.mark.parametrize("cf", [1.25, 0.25])
def test_scatter_rows_do_not_depend_on_the_batch(cf):
    """Groups are per sequence: each row alone gives its batched result."""
    cfg = _with_cf(get_config("qwen3-moe-235b-a22b", smoke=True), cf)
    _, tp = _mlp(2, cfg)
    x = torch.from_numpy(_rand(3, (3, 24, cfg.d_model), 0.1))
    batched, _ = moe.moe_mlp_scatter(tp, x, cfg)
    for b in range(3):
        alone, _ = moe.moe_mlp_scatter(tp, x[b:b + 1], cfg)
        _close(alone[0], batched[b], 1e-6)


@pytest.mark.parametrize("cf", [1.25, 0.25])
def test_scatter_gradients_match_jax_grad(cf):
    """Gradients through ``moe_mlp_scatter`` (mean(y^2) + 0.01 aux) to every
    weight, the router included, and to x, against ``jax.grad``."""
    cfg = _with_cf(get_config("qwen3-moe-235b-a22b", smoke=True), cf)
    jp, tp = _mlp(0, cfg)
    x = _rand(1, (2, 16, cfg.d_model), 0.1)

    def jloss(p, x):
        y, aux = jmoe.moe_mlp_scatter(p, x, cfg)
        return jnp.mean(y ** 2) + 0.01 * aux

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    tp = {k: v.requires_grad_(True) for k, v in tp.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux = moe.moe_mlp_scatter(tp, tx, cfg)
    (torch.mean(y ** 2) + 0.01 * aux).backward()
    assert float(tp["router"].grad.abs().max()) > 0.0
    for k in tp:
        _close(tp[k].grad, jgp[k], err_msg=k)
    _close(tx.grad, jgx)


def test_moe_hidden_remat_gradient_equals_plain(onehot_models):
    """``moe_hidden(remat=True)``: the same hidden state, aux loss and
    gradient as without recomputation."""
    _, _, cfg, params = onehot_models
    x = torch.from_numpy(_rand(7, (2, 8, cfg.d_model), 0.1))
    pos = torch.arange(8)
    outs = []
    for remat in (False, True):
        h = x.clone().requires_grad_(True)
        out, aux = moe.moe_hidden(params, cfg, h, pos, remat=remat)
        (out.square().mean() + aux).backward()
        outs.append((out.detach(), aux.detach(), h.grad))
    for a, b in zip(*outs):
        _close(a, b, 1e-6)


def test_moe_hidden_matches_the_reference(models):
    jcfg, jparams, cfg, params = models
    x = _rand(8, (2, 12, cfg.d_model), 0.5)
    jh, ja = jmoe.moe_hidden(jparams, jcfg, jnp.asarray(x), jnp.arange(12))
    th, ta = moe.moe_hidden(params, cfg, torch.from_numpy(x), torch.arange(12))
    _close(th, jh, TOL["float32"] * 4)
    _close(ta, ja)


# -- the flow path -----------------------------------------------------------


@pytest.mark.parametrize("t", [0.0, 0.5, 0.97])
def test_velocity(models, t):
    jcfg, jparams, cfg, params = models
    x = _rand(9, (2, 16, cfg.latent_dim))
    tok = _tokens(10, 2, 16, cfg.vocab)
    want = jmodel.velocity(jparams, jcfg, jnp.float32(t), jnp.asarray(x),
                           {"tokens": jnp.asarray(tok, jnp.int32)})
    got = tmodel.velocity(params, cfg, torch.tensor(t), torch.from_numpy(x),
                          {"tokens": torch.from_numpy(tok)})
    assert got.shape == x.shape and got.dtype == torch.float32
    _close(got, want, TOL["float32"] * 4)


def test_velocity_unconditional_branch(models):
    jcfg, jparams, cfg, params = models
    x = _rand(11, (2, 10, cfg.latent_dim))
    want = jmodel.velocity(jparams, jcfg, jnp.float32(0.3), jnp.asarray(x), None)
    got = tmodel.velocity(params, cfg, torch.tensor(0.3), torch.from_numpy(x), None)
    _close(got, want, TOL["float32"] * 4)


@pytest.mark.parametrize("arch", ARCHS)
def test_velocity_in_bf16(arch):
    """The bf16 model (weights cast by ``cast_params``' rule, the router's
    logits in f32 on both sides): velocity within the bf16 TOL."""
    jcfg = dataclasses.replace(jax_get_config(arch, smoke=True), dtype="bfloat16")
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="bfloat16")
    jp = jmodel.init_params(jax.random.PRNGKey(1), jcfg)
    tp = moe.params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    assert tp["layers"]["moe"]["w_up"].dtype == torch.bfloat16
    x = _rand(12, (2, 12, cfg.latent_dim))
    tok = _tokens(13, 2, 12, cfg.vocab)
    want = jmodel.velocity(jp, jcfg, jnp.float32(0.5), jnp.asarray(x),
                           {"tokens": jnp.asarray(tok, jnp.int32)})
    got = tmodel.velocity(tp, cfg, torch.tensor(0.5), torch.from_numpy(x),
                          {"tokens": torch.from_numpy(tok)})
    _close(got, want, TOL["bfloat16"])


def _reference_sampler(models, nfe=4):
    jcfg, jparams, _, _ = models
    js = jsched.fm_ot()
    return JaxFlowSampler(params=jparams, cfg=jcfg, sched=js,
                          solver=jreg.build_ns("euler", nfe, jmodel.velocity_field(
                              jparams, jcfg, js)))


def _sampler(models, nfe=4):
    _, _, cfg, params = models
    return FlowSampler(params=params, cfg=cfg, sched=tsched.fm_ot(),
                       solver=treg.build_ns("euler", nfe, None))


def test_sample_from_matches_reference(models):
    tok = _tokens(3, 2, 16, 256)
    x0 = _rand(14, (2, 16, 64))
    want = _reference_sampler(models).sample_from({"tokens": jnp.asarray(tok)},
                                                  jnp.asarray(x0))
    before = _launches()
    got = _sampler(models).sample_from({"tokens": torch.from_numpy(tok)}, x0)
    assert _launches() == before
    _close(got, want, TOL["float32"] * 4)


def test_flow_program_equals_eager(models, monkeypatch):
    """``FlowSampler``'s program captures the MoE forward (through the
    ``CPUGraph`` double): one program, replayed, equal to eager to the bit."""
    monkeypatch.setattr(programs, "_graph_double", CPUGraph)
    sampler = _sampler(models)
    tok = {"tokens": torch.from_numpy(_tokens(3, 2, 12, 256))}
    outs = [sampler.sample_from(tok, _rand(15 + i, (2, 12, 64))) for i in range(2)]
    assert (len(sampler.programs), sampler.programs.replays) == (1, 1)
    with programs.disabled():
        eager = [sampler.sample_from(tok, _rand(15 + i, (2, 12, 64))) for i in range(2)]
    for a, b in zip(outs, eager):
        assert torch.equal(a, b)


# -- decode --------------------------------------------------------------------


def _table(seed, B, nb):
    rng = np.random.default_rng(seed)
    return (rng.permutation(B * nb) + 1).reshape(B, nb).astype(np.int32)


@pytest.mark.parametrize("paged,kernel", [(False, False), (True, False), (True, True)])
def test_decode_logits_over_a_teacher_forced_sequence(models, paged, kernel):
    """Several steps of ``decode_apply`` over a dense cache and a paged one
    (through the kernel's plain version and the dense gather; the reference
    runs its Pallas kernel in interpret mode): logits and argmax equal the
    reference's."""
    jcfg, jparams, cfg, params = models
    B, T, ps, nb = 2, 6, 4, 2
    toks = np.random.default_rng(6).integers(0, cfg.vocab, size=(T, B)).astype(np.int32)
    if paged:
        table = _table(7, B, nb)
        jstate = jmodel.init_paged_decode_state(jcfg, B, 1 + B * nb, ps, nb, jnp.float32)
        jstate = jstate._replace(block_table=jnp.asarray(table))
        tstate = tmodel.init_paged_decode_state(cfg, B, 1 + B * nb, ps, nb, torch.float32,
                                                "cpu")
        tstate = tstate._replace(block_table=torch.from_numpy(table))
    else:
        jstate = jmodel.init_decode_state(jcfg, B, 8, jnp.float32)
        tstate = tmodel.init_decode_state(cfg, B, 8, torch.float32, "cpu")
    before = _launches()
    for t in range(T):
        want, jstate = jmodel.decode_apply(jparams, jcfg, jnp.asarray(toks[t]), jstate,
                                           paged_kernel=kernel)
        got, tstate = tmodel.decode_apply(params, cfg, torch.from_numpy(toks[t]), tstate,
                                          paged_kernel=kernel)
        assert got.shape == (B, cfg.vocab) and got.dtype == torch.float32
        _close(got, want, TOL["float32"] * 4, err_msg=f"step {t}")
        assert got.argmax(-1).tolist() == np.asarray(jnp.argmax(want, -1)).tolist()
    assert _launches() == before                       # the CPU runs the plain versions
    np.testing.assert_array_equal(np.broadcast_to(tstate.index.numpy(), (B,)),
                                  np.broadcast_to(np.asarray(jstate.index), (B,)))


def test_decode_matches_prefill(models):
    """Token-by-token decode reproduces the reference's full-sequence
    ``lm_apply`` logits (tests/test_archs_smoke.py's check, at its 2e-2, and
    as there with capacity factor 8: prefill (T = B·S) and decode (T = B)
    drop differently, and agree where nothing is dropped)."""
    jcfg, jparams, cfg, params = models
    jcfg, cfg = _with_cf(jcfg, 8.0), _with_cf(cfg, 8.0)
    tok = _tokens(16, 2, 8, cfg.vocab)
    want = jmodel.lm_apply(jparams, jcfg, {"tokens": jnp.asarray(tok, jnp.int32)})
    state = tmodel.init_decode_state(cfg, 2, 8, torch.float32, device="cpu")
    got = torch.stack([tmodel.decode_apply(params, cfg, torch.from_numpy(tok[:, i]),
                                           state)[0] for i in range(8)], dim=1)
    _close(got, want, 2e-2)


def test_decode_state_is_the_dense_family_s(onehot_models):
    _, _, cfg, _ = onehot_models
    assert tmodel.decode_state_batch_axes(cfg) == KVCache(k=1, v=1, index=0)
    axes = tmodel.decode_state_batch_axes(cfg, paged=True)
    assert (axes.k_pages, axes.v_pages, axes.block_table, axes.index) == (-1, -1, 0, 0)
    state = tmodel.init_decode_state(cfg, 2, 8, torch.float32, "cpu")
    assert tuple(state.k.shape) == (cfg.n_layers, 2, 8, cfg.n_kv_heads, cfg.resolved_head_dim)


def test_decode_step_writes_only_active_rows(models):
    """A step with row 1 inactive leaves its cache rows and position as they
    were; row 0 advances as in an all-active step."""
    _, _, cfg, params = models
    state = tmodel.init_decode_state(cfg, 2, 8, torch.float32, "cpu")
    state = state._replace(index=torch.zeros(2, dtype=torch.int32))
    tok = torch.tensor([5, 9])
    tmodel.decode_apply(params, cfg, tok, state)
    k1, v1 = state.k[:, 1].clone(), state.v[:, 1].clone()
    full = tmodel.init_decode_state(cfg, 2, 8, torch.float32, "cpu")
    full = full._replace(index=torch.zeros(2, dtype=torch.int32))
    tmodel.decode_apply(params, cfg, tok, full)
    lg_full, _ = tmodel.decode_apply(params, cfg, tok, full)
    lg, _ = tmodel.decode_apply(params, cfg, tok, state, active=torch.tensor([True, False]))
    assert state.index.tolist() == [2, 1]
    assert torch.equal(state.k[:, 1], k1) and torch.equal(state.v[:, 1], v1)
    _close(lg[0], lg_full[0], 1e-6)


@pytest.mark.parametrize("page_size,kernel", [(0, False), (4, True)])
def test_served_tokens_match_the_reference_gateway(models, page_size, kernel):
    """The same mixed request list through both decode gateways (dense, and
    paged through the kernel's plain version): the same tokens, slots and
    join steps, and the same counts."""
    jcfg, jparams, cfg, params = models
    spec = [([3, 7], 5), ([5], 3), ([9, 1, 4, 4, 2, 8], 4), ([2, 2], 6), ([11, 13, 6], 2)]
    kw = dict(max_slots=2, cache_slots=16, prefill_chunk=4)
    ekw = dict(page_size=page_size, paged_kernel=kernel)
    jgw = jdecode.DecodeGateway(jengine.DecodeEngine(params=jparams, cfg=jcfg, **ekw), **kw)
    tgw = DecodeGateway(DecodeEngine(params=params, cfg=cfg, **ekw), **kw)
    jfut = [jgw.submit(jdecode.DecodeRequest(prompt=p, max_tokens=t)) for p, t in spec]
    tfut = [tgw.submit(DecodeRequest(prompt=p, max_tokens=t)) for p, t in spec]
    for gw, futures in ((jgw, jfut), (tgw, tfut)):
        while not all(f.done() for f in futures):
            gw.pump()
    for jf, tf in zip(jfut, tfut):
        assert tf.result().tokens.tolist() == jf.result().tokens.tolist()
        for key in ("finish_reason", "new_tokens", "slot", "join_step"):
            assert tf.result().meta[key] == jf.result().meta[key], key
    keys = ("completed", "forwards", "prefill_calls", "joins", "tokens_out")
    assert {k: tgw.stats()[k] for k in keys} == {k: jgw.stats()[k] for k in keys}


@pytest.mark.parametrize("page_size", [0, 4])
def test_decode_programs_equal_eager_and_keep_the_state_leaves(onehot_models, monkeypatch,
                                                               page_size):
    """prefill, greedy and sampled steps through the ``CPUGraph`` double,
    dense and paged: every state leaf keeps its tensor, the programs replay,
    and tokens and state equal the eager engine's to the bit."""
    monkeypatch.setattr(programs, "_graph_double", CPUGraph)
    _, _, cfg, params = onehot_models
    S, C = 3, 4
    engines = [DecodeEngine(params=params, cfg=cfg, page_size=page_size,
                            paged_kernel=bool(page_size)) for _ in range(2)]
    states = [e.init_slot_state(S, 16) for e in engines]
    if page_size:
        table = (np.arange(S * 4) + 1).reshape(S, 4).astype(np.int32)
        states = [e.with_block_table(s, table) for e, s in zip(engines, states)]
    sampling = SlotSampling(seeds=np.arange(S, dtype=np.uint64) + 7,
                            counts=np.zeros(S, np.int32),
                            temps=np.array([0.0, 0.8, 1.2], np.float32),
                            top_ks=np.array([0, 5, 0], np.int32),
                            top_ps=np.array([1.0, 1.0, 0.9], np.float32))
    prompt = np.random.default_rng(4).integers(0, cfg.vocab, size=(S, C)).astype(np.int32)
    ptrs = [leaf.data_ptr() for leaf in states[0]]
    toks = [[], []]
    for i, (eng, state) in enumerate(zip(engines, states)):
        with programs.disabled() if i else contextlib.nullcontext():
            state = eng.prefill_slots(prompt, np.array([4, 3, 2], np.int32), state,
                                      np.ones(S, bool))
            feed = prompt[:, 0]
            for step in range(4):
                active = np.array([True, step % 2 == 0, True])
                samp = sampling._replace(counts=np.full(S, step, np.int32))
                feed, state = eng.step_slots(feed, state, active,
                                             sampling=samp if step % 2 else None)
                toks[i].append(np.asarray(feed))
        states[i] = state
    assert [leaf.data_ptr() for leaf in states[0]] == ptrs
    # prefill, greedy and sampled: each captured once, the steps replayed once
    assert (len(engines[0].programs), engines[0].programs.replays) == (3, 2)
    assert len(engines[1].programs) == 0
    for a, b in zip(*toks):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(*states):
        assert torch.equal(a, b)


# -- paged attention at 16 query heads a KV head (qwen3-moe-235b-a22b's G) ------


def _paged_inputs(seed, B, KV, G, hd, ps, nb, dtype):
    rng = np.random.default_rng(seed)
    num_pages = 1 + B * nb
    q = rng.standard_normal((B, KV, G, hd)).astype(np.float32)
    k = rng.standard_normal((num_pages, ps, KV, hd)).astype(np.float32)
    v = rng.standard_normal((num_pages, ps, KV, hd)).astype(np.float32)
    table = (rng.permutation(num_pages - 1)[:B * nb] + 1).reshape(B, nb).astype(np.int32)
    lengths = np.asarray([(i * ps + 3 * i + 1) % (nb * ps) + 1 for i in range(B)], np.int32)
    return q, k, v, table, lengths


@pytest.mark.parametrize("q_dtype,page_dtype", [("float32", "float32"),
                                                ("bfloat16", "bfloat16"),
                                                ("bfloat16", "float32")])
@pytest.mark.parametrize("G,hd", [(16, 128), (16, 32), (12, 64)])
def test_paged_attention_at_g_16_matches_pallas(G, hd, q_dtype, page_dtype):
    """The plain version and ``paged_attend``'s CPU route against the
    reference's Pallas kernel in interpret mode, at up to 16 query heads a
    KV head (qwen3-moe-235b-a22b: 64 over 4)."""
    B, KV, ps, nb = 3, 2, 8, 3
    q, k, v, table, lengths = _paged_inputs(G * hd + B, B, KV, G, hd, ps, nb, q_dtype)
    tq = torch.from_numpy(q).to(getattr(torch, q_dtype))
    tk, tv = (torch.from_numpy(a).to(getattr(torch, page_dtype)) for a in (k, v))
    jq = jnp.asarray(q).astype(q_dtype)
    jk, jv = (jnp.asarray(a).astype(page_dtype) for a in (k, v))
    want = jax_paged(jq, jk, jv, jnp.asarray(table), jnp.asarray(lengths), interpret=True)
    before = pa_mod.COUNTER.launches
    for got in (paged_attention_ref(tq, tk, tv, torch.from_numpy(table),
                                    torch.from_numpy(lengths)),
                paged_attend(tq, tk, tv, torch.from_numpy(table),
                             torch.from_numpy(lengths))):
        assert got.shape == (B, KV, G, hd) and got.dtype == tq.dtype
        _close(got, want, TOL[q_dtype] * 4)
    assert pa_mod.COUNTER.launches == before


def test_paged_kernel_takes_the_reference_s_group_sizes():
    """The kernel's limit covers every served config's group (64 / 4 = 16 at
    qwen3-moe-235b-a22b) and matches its source's ``kMaxG``."""
    from pathlib import Path

    from repro_torch.kernels import build

    src = Path(build.CSRC, "paged_attention.cu").read_text()
    assert pa_mod.MAX_GROUP == 16 and "constexpr int kMaxG = 16;" in src
    groups = {a: get_config(a).n_heads // get_config(a).n_kv_heads
              for a in ("qwen3-moe-235b-a22b", "qwen3-moe-30b-a3b", "yi-34b",
                        "command-r-35b", "phi3-medium-14b")}
    assert groups == {"qwen3-moe-235b-a22b": 16, "qwen3-moe-30b-a3b": 8, "yi-34b": 7,
                      "command-r-35b": 8, "phi3-medium-14b": 4}
    assert max(groups.values()) <= pa_mod.MAX_GROUP


# -- the launcher ----------------------------------------------------------------


@pytest.fixture
def shared_weights(monkeypatch):
    """The port's launcher builds the reference launcher's weights (the
    reference initializer at the same seed, transferred)."""
    trees = {}

    def init(gen, cfg, device):
        if cfg.name not in trees:
            jcfg = jax_get_config(cfg.name, smoke=True)
            trees[cfg.name] = jax.tree.map(np.asarray, jmodel.init_params(
                jax.random.PRNGKey(0), jcfg))
        return moe.params_from_jax(trees[cfg.name], cfg, device)

    monkeypatch.setattr(tmodel, "init_params", init)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_flow_matches_the_reference_launcher(arch, shared_weights, monkeypatch,
                                                   capsys):
    """Both launchers at the same flags, weights and conditioning, each
    request's noise from one numpy seed: latents within 2e-5 x NFE."""
    from repro.launch import serve as jserve

    noise = [_rand(1000 + r, (2, 16, 64)) for r in range(2)]
    got, want = [], []

    def fixed(store, to):
        def sample(self, batch, _rng):
            out = self.sample_from(batch, to(noise[len(store)]))
            store.append(out)
            return out
        return sample

    monkeypatch.setattr(JaxFlowSampler, "sample", fixed(want, jnp.asarray))
    monkeypatch.setattr(FlowSampler, "sample", fixed(got, lambda x: x))
    flags = ["--mode", "flow", "--nfe", "4", "--batch", "2", "--seq", "16", "--requests",
             "2", "--bns-iters", "0"]
    jserve.serve_flow(jserve.build_parser().parse_args(["--arch", arch] + flags))
    before = _launches()
    served = serve.main(["--arch", arch, "--device", "cpu"] + flags)
    assert _launches() == before
    assert "request 1: sampled (2, 16) in" in capsys.readouterr().out
    assert len(served) == len(got) == len(want) == 2
    for s, g, w in zip(served, got, want):
        assert s.nfe == 4 and s.latents is g and s.tokens.shape == (2, 16)
        _close(g, w, TOL["float32"] * 4)
        assert int(s.tokens.min()) >= 0 and int(s.tokens.max()) < 256


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_decode_paged_gateway_matches_the_reference_launcher(arch, shared_weights,
                                                                   monkeypatch, capsys):
    """Both launchers' paged decode gateways (the kernel's plain version on
    the CPU, the Pallas kernel in interpret mode): the same tokens and
    counts."""
    from repro.launch import serve as jserve

    futures = []
    real = jdecode.DecodeGateway.submit

    def submit(self, req):
        futures.append(real(self, req))
        return futures[-1]

    monkeypatch.setattr(jdecode.DecodeGateway, "submit", submit)
    flags = ["--mode", "decode", "--gateway", "--page-size", "4", "--paged-kernel",
             "--max-slots", "2", "--slots", "16", "--requests", "5",
             "--decode-lengths", "4,2"]
    jserve.serve_decode(jserve.build_parser().parse_args(["--arch", arch] + flags))
    served = serve.main(["--arch", arch, "--device", "cpu"] + flags)
    assert "request 4: 4 tokens (length)" in capsys.readouterr().out
    assert [r.meta["new_tokens"] for r in served.responses] == [4, 2, 4, 2, 4]
    assert [r.tokens.tolist() for r in served.responses] == \
        [f.result().tokens.tolist() for f in futures]
    s = served.stats
    assert (s["completed"], s["failed"], s["tokens_out"], s["pages_in_use"]) == (5, 0, 16, 0)
