"""The port's hybrid family (Mamba2 SSD blocks and Zamba2's shared attention)
against the JAX reference, on the CPU.

zamba2-2.7b's smoke config (4 layers, a shared-attention site every 2,
d_model 128, 8 SSM heads of 32 over a d_state of 16, f32, chunk 16). The
reference's params from ``init_params(PRNGKey(0), cfg)``, with ``A_log``,
``D``, ``dt_bias``, ``gate_norm`` and the norms redrawn from a numpy seed so
that every term of the block is live (the reference's initial A is -1 in
every head, D 1, every norm 1), go to both sides as numpy. Inputs and noise
are made with numpy from a seed. Tolerances are ``tests/test_kernels.py``'s
f32 2e-5, scaled by NFE for the solver's accumulated sum; decode against the
reference's full-sequence ``lm_apply`` at 2e-2, as
``tests/test_archs_smoke.py::test_decode_matches_prefill``.
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
from repro.models import mamba2 as jmamba
from repro.models import model as jmodel
from repro.serving import decode as jdecode
from repro.serving import engine as jengine
from repro.serving.engine import FlowSampler as JaxFlowSampler
from repro.solvers import registry as jreg
from repro_torch.configs import get_config
from repro_torch.core import schedulers as tsched
from repro_torch.kernels.flash_attention import flash_attention as fa_mod
from repro_torch.kernels.gla_scan import gla_scan as gs_mod
from repro_torch.kernels.ns_update import ns_update as nu_mod
from repro_torch.launch import serve
from repro_torch.models import mamba2
from repro_torch.models import model as tmodel
from repro_torch.serving import programs
from repro_torch.serving.decode import DecodeGateway, DecodeRequest
from repro_torch.serving.engine import DecodeEngine, FlowSampler, SlotSampling
from repro_torch.solvers import registry as treg
from torch_graph_double import CPUGraph

TOL = 2e-5                       # tests/test_kernels.py, f32
ARCH = "zamba2-2.7b"
KERNELS = (fa_mod.COUNTER, gs_mod.COUNTER, nu_mod.COUNTER)


def _live(tree: dict, seed: int) -> dict:
    """The reference tree (numpy) with the per-head constants and the norms
    redrawn."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.array, tree)
    lay, sa = tree["layers"], tree["shared_attn"]
    for key, fn in (("A_log", lambda s: 0.5 * rng.standard_normal(s)),
                    ("D", lambda s: 1.0 + 0.5 * rng.standard_normal(s)),
                    ("dt_bias", lambda s: -2.0 + rng.standard_normal(s)),
                    ("gate_norm", lambda s: 1.0 + 0.1 * rng.standard_normal(s)),
                    ("norm", lambda s: 1.0 + 0.1 * rng.standard_normal(s))):
        lay[key] = fn(lay[key].shape).astype(lay[key].dtype)
    for key in ("norm1", "norm2"):
        sa[key] = (1.0 + 0.1 * rng.standard_normal(sa[key].shape)).astype(np.float32)
    return tree


@pytest.fixture(scope="module")
def models():
    jcfg = jax_get_config(ARCH, smoke=True)
    tree = _live(jmodel.init_params(jax.random.PRNGKey(0), jcfg), 0)
    jparams = jax.tree.map(jnp.asarray, tree)
    cfg = get_config(ARCH, smoke=True)
    return jcfg, jparams, cfg, mamba2.params_from_jax(tree, cfg, device="cpu")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol=TOL, **kw):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol, **kw)


def _rand(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _tokens(seed, B, S, vocab):
    return np.random.default_rng(seed).integers(0, vocab, size=(B, S))


def _flatten(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + k + ".")
        else:
            yield prefix + k, v


def _layer(params, i):
    return {k: v[i] for k, v in params["layers"].items()}


def _launches():
    return tuple(c.launches for c in KERNELS)


@pytest.mark.parametrize("smoke", [True, False])
def test_config_is_the_reference_config(smoke):
    assert dataclasses.asdict(get_config(ARCH, smoke=smoke)) == \
        dataclasses.asdict(jax_get_config(ARCH, smoke=smoke))
    assert get_config(ARCH, smoke=smoke).param_count() == \
        jax_get_config(ARCH, smoke=smoke).param_count()
    full = get_config(ARCH)
    assert (full.family, full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
            full.resolved_head_dim, full.hybrid_attn_every, full.d_ff, full.vocab,
            full.ssm.d_state, full.ssm.head_dim, full.ssm.chunk, full.dtype) == \
        ("hybrid", 54, 2560, 32, 32, 80, 6, 10240, 32000, 64, 64, 64, "bfloat16")
    assert mamba2._dims(full) == jmamba._dims(full) == (5120, 80, 5248)


def test_params_from_jax_is_a_transfer(models):
    jcfg, jparams, cfg, params = models
    flat = dict(_flatten(params))
    for path, leaf in jax.tree_util.tree_flatten_with_path(jparams)[0]:
        t = flat[".".join(k.key for k in path)]
        assert tuple(t.shape) == leaf.shape
        assert str(t.dtype).removeprefix("torch.") == str(leaf.dtype)
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))
    assert len(flat) == len(jax.tree.leaves(jparams))


def test_params_from_jax_takes_only_the_hybrid_tree(models):
    _, jparams, cfg, _ = models
    tree = jax.tree.map(np.asarray, jparams)
    with pytest.raises(ValueError, match="layer tree"):
        mamba2.params_from_jax({**tree, "layers": {"attn": {}, "mlp": {}}}, cfg,
                               device="cpu")
    with pytest.raises(ValueError, match="param tree"):
        mamba2.params_from_jax({k: v for k, v in tree.items() if k != "shared_attn"}, cfg,
                               device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_hybrid_params_has_the_reference_tree(dtype):
    """Same keys, shapes and dtypes as the reference initializer under
    ``cast_params``' rule (the stacked per-layer leaves take the model dtype,
    only the 1-D final norm and the shared block's norms stay f32); the
    constant leaves equal, the random draws at the same scales."""
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), dtype=dtype)
    jcfg = dataclasses.replace(jax_get_config(ARCH, smoke=True), dtype=dtype)
    ours = dict(_flatten(tmodel.init_params(torch.Generator().manual_seed(0), cfg,
                                            device="cpu")))
    ref = {".".join(k.key for k in path): leaf for path, leaf in
           jax.tree_util.tree_flatten_with_path(jmodel.init_params(jax.random.PRNGKey(0),
                                                                   jcfg))[0]}
    assert ours.keys() == ref.keys()
    for key, leaf in ref.items():
        assert tuple(ours[key].shape) == leaf.shape, key
        assert str(ours[key].dtype).removeprefix("torch.") == str(leaf.dtype), key
    for key in ("final_norm", "shared_attn.norm1", "shared_attn.norm2"):
        assert ours[key].dtype == torch.float32
    for key in ("layers.A_log", "layers.D", "layers.dt_bias", "layers.gate_norm",
                "layers.norm"):
        np.testing.assert_array_equal(_np(ours[key]), np.asarray(ref[key], np.float32))
    w = ours["layers.in_proj"].float()
    assert abs(float(w.std()) - cfg.d_model ** -0.5) < 0.1 * cfg.d_model ** -0.5
    assert abs(float(ours["layers.conv_w"].float().std()) - 0.1) < 0.02


def test_init_refuses_a_depth_off_the_superblocks():
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), n_layers=3)
    with pytest.raises(ValueError, match="hybrid_attn_every"):
        tmodel.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")


def _ssd_inputs(cfg, seed, L):
    d_inner, n_heads, _ = mamba2._dims(cfg)
    B = 2
    return (_rand(seed, (B, L, d_inner)), _rand(seed + 1, (B, L, cfg.ssm.d_state)),
            _rand(seed + 2, (B, L, cfg.ssm.d_state)), _rand(seed + 3, (B, L, n_heads)))


@pytest.mark.parametrize("L,with_s0", [(32, False), (20, False), (20, True)])
def test_ssd(models, L, with_s0):
    """A multiple of the chunk (16) and not, with and without an initial
    state: the port's route (ops.gla: q and k stride-0 over the heads, one
    decay a head) against the reference's ``gla_chunked`` call."""
    jcfg, jparams, cfg, params = models
    x, Bm, Cm, dt = _ssd_inputs(cfg, 10 + L, L)
    _, n_heads, _ = mamba2._dims(cfg)
    s0 = _rand(7, (2, n_heads, cfg.ssm.d_state, cfg.ssm.head_dim)) if with_s0 else None
    jp, p = _layer(jparams, 1), _layer(params, 1)
    wy, wS = jmamba._ssd(jcfg, *map(jnp.asarray, (x, Bm, Cm, dt)), jp,
                         None if s0 is None else jnp.asarray(s0))
    before = _launches()
    gy, gS = mamba2._ssd(cfg, *map(torch.from_numpy, (x, Bm, Cm, dt)), p,
                         None if s0 is None else torch.from_numpy(s0))
    assert _launches() == before                               # CPU: the plain route
    assert gy.shape == (2, L, mamba2._dims(cfg)[0]) and gS.dtype == torch.float32
    _close(gy, wy)
    _close(gS, wS)


def test_ssd_goes_through_the_kernel_route_with_stride_0_heads(models, monkeypatch):
    """``_ssd`` hands ops.gla the model's own views: q and k one group of
    shape (B, L, 1, d_state) over the model's products (no copy), which the
    kernel route reads with a stride of 0 over the heads, ld with a trailing
    dim of 1, inclusive."""
    _, _, cfg, params = models
    seen = {}
    real = mamba2.gla_ops.gla

    def spy(q, k, v, ld, s0=None, **kw):
        seen.update(q=q, k=k, ld=ld, kw=kw)
        return real(q, k, v, ld, s0, **kw)

    monkeypatch.setattr(mamba2.gla_ops, "gla", spy)
    x, Bm, Cm, dt = _ssd_inputs(cfg, 3, 16)
    xbc = torch.from_numpy(np.concatenate([x, Bm, Cm], axis=-1))
    d_inner, n_heads, _ = mamba2._dims(cfg)
    ds = cfg.ssm.d_state
    mamba2._ssd(cfg, xbc[..., :d_inner], xbc[..., d_inner:d_inner + ds],
                xbc[..., d_inner + ds:], torch.from_numpy(dt), _layer(params, 0))
    assert seen["q"].shape[2] == 1 and seen["k"].shape[2] == 1
    v = torch.zeros((2, 16, n_heads, cfg.ssm.head_dim))
    assert all(t.stride(2) == 0 for t in mamba2.gla_ops._heads(seen["q"], seen["k"], v))
    assert seen["q"].data_ptr() == xbc[..., d_inner + ds:].data_ptr()
    assert seen["k"].data_ptr() == xbc[..., d_inner:].data_ptr()
    assert tuple(seen["ld"].shape) == (2, 16, n_heads, 1)
    assert seen["kw"] == dict(inclusive=True, chunk=cfg.ssm.chunk)


@pytest.mark.parametrize("L", [16, 11])
def test_mamba_block_seq(models, L):
    jcfg, jparams, cfg, params = models
    h = _rand(20 + L, (2, L, cfg.d_model))
    want = jmamba.mamba_block_seq(_layer(jparams, 2), jcfg, jnp.asarray(h))
    got = mamba2.mamba_block_seq(_layer(params, 2), cfg, torch.from_numpy(h))
    _close(got, want)


def test_mamba_block_step(models):
    """Five steps of one block from a non-zero conv tail and state."""
    jcfg, jparams, cfg, params = models
    _, n_heads, conv_dim = mamba2._dims(cfg)
    conv = _rand(30, (3, cfg.ssm.d_conv - 1, conv_dim))
    S = _rand(31, (3, n_heads, cfg.ssm.d_state, cfg.ssm.head_dim))
    jc, jS, tc, tS = jnp.asarray(conv), jnp.asarray(S), torch.from_numpy(conv), \
        torch.from_numpy(S)
    for step in range(5):
        h = _rand(40 + step, (3, cfg.d_model))
        wh, jc, jS = jmamba.mamba_block_step(_layer(jparams, 3), jcfg, jnp.asarray(h), jc, jS)
        gh, tc, tS = mamba2.mamba_block_step(_layer(params, 3), cfg, torch.from_numpy(h),
                                             tc, tS)
        for got, want in ((gh, wh), (tc, jc), (tS, jS)):
            _close(got, want, err_msg=f"step {step}")


@pytest.mark.parametrize("window", [0, 5])
def test_shared_attn_seq(models, window):
    jcfg, jparams, cfg, params = models
    h = _rand(50, (2, 12, cfg.d_model))
    pos = np.arange(12)
    want = jmamba._shared_attn_seq(jparams["shared_attn"], jcfg, jnp.asarray(h),
                                   jnp.asarray(pos), window)
    got = mamba2._shared_attn_seq(params["shared_attn"], cfg, torch.from_numpy(h),
                                  torch.from_numpy(pos), window)
    _close(got, want)


@pytest.mark.parametrize("remat", [False, True])
def test_hybrid_hidden(models, remat):
    jcfg, jparams, cfg, params = models
    h = _rand(60, (2, 20, cfg.d_model))
    want = jmamba.hybrid_hidden(jparams, jcfg, jnp.asarray(h), remat=remat)
    got = mamba2.hybrid_hidden(params, cfg, torch.from_numpy(h), remat=remat)
    _close(got, want)


def test_hybrid_hidden_remat_gradient(models):
    """The gradient through the recomputed superblocks (``checkpoint``)
    against ``jax.grad`` of the reference's ``jax.checkpoint`` body: d/dh and
    d/d(in_proj, A_log, dt_bias, conv_w, the shared wq) of <hidden, ct>."""
    jcfg, jparams, cfg, params = models
    h = _rand(61, (2, 20, cfg.d_model))
    ct = _rand(62, (2, 20, cfg.d_model))
    keys = ("in_proj", "A_log", "dt_bias", "conv_w")

    def jloss(p, h):
        return jnp.sum(jmamba.hybrid_hidden(p, jcfg, h, remat=True) * ct)

    jg_p, jg_h = jax.grad(jloss, argnums=(0, 1))(jparams, jnp.asarray(h))
    th = torch.from_numpy(h).requires_grad_(True)
    leaves = [params["layers"][k].clone().requires_grad_(True) for k in keys]
    wq = params["shared_attn"]["attn"]["wq"].clone().requires_grad_(True)
    p = {**params, "layers": {**params["layers"], **dict(zip(keys, leaves))},
         "shared_attn": {**params["shared_attn"],
                         "attn": {**params["shared_attn"]["attn"], "wq": wq}}}
    loss = torch.sum(mamba2.hybrid_hidden(p, cfg, th, remat=True) * torch.from_numpy(ct))
    grads = torch.autograd.grad(loss, [th, wq] + leaves)
    wants = [jg_h, jg_p["shared_attn"]["attn"]["wq"]] + [jg_p["layers"][k] for k in keys]
    for name, got, want in zip(("h", "wq") + keys, grads, wants):
        scale = float(np.abs(_np(want)).max())
        np.testing.assert_allclose(_np(got), _np(want), atol=TOL * scale, rtol=TOL * 10,
                                   err_msg=name)


@pytest.mark.parametrize("L", [32, 20])          # a multiple of the chunk (16), and not
@pytest.mark.parametrize("t", [0.0, 0.6])
def test_velocity(models, L, t):
    jcfg, jparams, cfg, params = models
    x = _rand(4 + L, (2, L, cfg.latent_dim))
    tok = _tokens(5, 2, L, cfg.vocab)
    want = jmodel.velocity(jparams, jcfg, jnp.float32(t), jnp.asarray(x),
                           {"tokens": jnp.asarray(tok, jnp.int32)})
    before = _launches()
    got = tmodel.velocity(params, cfg, torch.tensor(t), torch.from_numpy(x),
                          {"tokens": torch.from_numpy(tok)})
    assert _launches() == before                               # CPU: the plain routes
    assert got.dtype == torch.float32 and got.shape == x.shape
    _close(got, want)


def test_velocity_unconditional_branch(models):
    jcfg, jparams, cfg, params = models
    x = _rand(6, (2, 24, cfg.latent_dim))
    want = jmodel.velocity(jparams, jcfg, jnp.float32(0.3), jnp.asarray(x), None)
    got = tmodel.velocity(params, cfg, torch.tensor(0.3), torch.from_numpy(x), None)
    _close(got, want)


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


@pytest.mark.parametrize("L", [16, 12])
def test_sample_from_matches_reference(models, L):
    tok = _tokens(3, 2, L, 256)
    x0 = _rand(11, (2, L, 64))
    want = _reference_sampler(models).sample_from({"tokens": jnp.asarray(tok)},
                                                  jnp.asarray(x0))
    before = _launches()
    got = _sampler(models).sample_from({"tokens": torch.from_numpy(tok)}, x0)
    assert _launches() == before
    _close(got, want, TOL * 4)


def test_flow_program_equals_eager(models, monkeypatch):
    """``FlowSampler``'s program captures the hybrid forward (through the
    ``CPUGraph`` double): one program, replayed, equal to eager to the bit."""
    monkeypatch.setattr(programs, "_graph_double", CPUGraph)
    sampler = _sampler(models)
    tok = {"tokens": torch.from_numpy(_tokens(3, 2, 12, 256))}
    outs = [sampler.sample_from(tok, _rand(12 + i, (2, 12, 64))) for i in range(2)]
    assert (len(sampler.programs), sampler.programs.replays) == (1, 1)
    with programs.disabled():
        eager = [sampler.sample_from(tok, _rand(12 + i, (2, 12, 64))) for i in range(2)]
    for a, b in zip(outs, eager):
        assert torch.equal(a, b)


def test_decode_logits_and_greedy_tokens_match_reference(models):
    """Six steps of the reference's decode_step (scalar index) and the
    port's, fed the reference's greedy tokens: logits within f32 TOL, the
    same argmax, the same state."""
    jcfg, jparams, cfg, params = models
    jstate = jmamba.init_state(jcfg, 3, 8, jnp.float32)
    state = tmodel.init_decode_state(cfg, 3, 8, torch.float32, device="cpu")
    assert isinstance(state, mamba2.HybridState) and state.ssm.dtype == torch.float32
    assert [tuple(a.shape) for a in state] == [tuple(b.shape) for b in jstate]
    jstep = jax.jit(lambda p, t, s: jmamba.decode_step(p, jcfg, t, s))
    tok = np.array([3, 7, 200], np.int32)
    for step in range(6):
        jl, jstate = jstep(jparams, jnp.asarray(tok), jstate)
        tl, state = tmodel.decode_apply(params, cfg, torch.from_numpy(tok), state)
        _close(tl, jl, err_msg=f"step {step}")
        nxt = np.array(jnp.argmax(jl, -1), np.int32)
        assert torch.argmax(tl, -1).numpy().tolist() == nxt.tolist()
        tok = nxt
    assert int(state.index) == 6
    for got, want in zip(state[:4], jstate[:4]):
        _close(got, want)


def test_decode_matches_prefill(models):
    """Token-by-token decode reproduces the reference's full-sequence
    ``lm_apply`` logits (tests/test_archs_smoke.py's check, at its 2e-2)."""
    jcfg, jparams, cfg, params = models
    tok = _tokens(8, 2, 8, cfg.vocab)
    want = jmodel.lm_apply(jparams, jcfg, {"tokens": jnp.asarray(tok, jnp.int32)})
    state = tmodel.init_decode_state(cfg, 2, 8, torch.float32, device="cpu")
    got = torch.stack([tmodel.decode_apply(params, cfg, torch.from_numpy(tok[:, i]),
                                           state)[0] for i in range(8)], dim=1)
    _close(got, want, 2e-2)


def test_decode_long_window(models):
    """A window of 4 over 4 slots and 7 steps: the ring buffer wraps; every
    step's logits equal the reference's (tests/test_archs_smoke.py's
    test_decode_long_window, held to the reference)."""
    jcfg, jparams, cfg, params = models
    jstate = jmamba.init_state(jcfg, 2, 4, jnp.float32)
    state = tmodel.init_decode_state(cfg, 2, 4, torch.float32, device="cpu")
    jstep = jax.jit(lambda p, t, s: jmamba.decode_step(p, jcfg, t, s, window=4))
    tok = np.zeros((2,), np.int32)
    for step in range(7):
        jl, jstate = jstep(jparams, jnp.asarray(tok), jstate)
        tl, state = tmodel.decode_apply(params, cfg, torch.from_numpy(tok), state, window=4)
        _close(tl, jl, err_msg=f"step {step}")
        tok = np.array(jnp.argmax(jl, -1), np.int32)
    assert bool(torch.isfinite(tl).all())
    _close(state.kv, jstate.kv)


def test_decode_step_writes_only_active_rows(models):
    """``active`` picks the rows a step advances: the others keep every bit
    of conv, ssm, kv and vv, and their position."""
    _, _, cfg, params = models
    state = tmodel.init_decode_state(cfg, 3, 8, torch.float32, device="cpu")
    state = state._replace(index=torch.zeros((3,), dtype=torch.int32))
    tok = torch.tensor([3, 7, 9])
    _, state = tmodel.decode_apply(params, cfg, tok, state)
    frozen = [leaf[:, 1].clone() for leaf in state[:4]]
    ptrs = [leaf.data_ptr() for leaf in state]
    active = torch.tensor([True, False, True])
    for _ in range(2):
        _, state = tmodel.decode_apply(params, cfg, tok, state, active=active)
    assert state.index.tolist() == [3, 1, 3]
    assert [leaf.data_ptr() for leaf in state] == ptrs
    for leaf, before in zip(state[:4], frozen):
        assert torch.equal(leaf[:, 1], before)
    for leaf in state[:4]:
        assert not torch.equal(leaf[:, 0], leaf[:, 1])


def test_decode_state_axes_and_no_paged_state(models):
    _, _, cfg, params = models
    axes = mamba2.HybridState(conv=1, ssm=1, kv=1, vv=1, index=0)
    assert tmodel.decode_state_batch_axes(cfg) == axes
    assert tmodel.decode_state_batch_axes(cfg, paged=True) == axes
    with pytest.raises(TypeError, match="paged KV cache not supported"):
        tmodel.init_paged_decode_state(cfg, 2, 8, 4, 2, device="cpu")
    with pytest.raises(TypeError, match="pageable"):          # tests/test_paged_decode.py
        DecodeEngine(params=params, cfg=cfg, page_size=4)
    engine = DecodeEngine(params=params, cfg=cfg)
    assert engine.seq_capacity_bounded and not engine.paged     # the shared attention's cache
    assert not DecodeEngine(params=params, cfg=cfg, window=4).seq_capacity_bounded


@pytest.fixture(scope="module")
def engine(models):
    _, _, cfg, params = models
    return DecodeEngine(params=params, cfg=cfg)


def _solo_tokens(engine, prompt, n):
    """Teacher-force ``prompt`` through the plain scalar-index decode path,
    then greedy: independent of the slot machinery."""
    state = engine.init_state(1, 32)
    for tok in prompt[:-1]:
        _, state = engine.step(torch.tensor([tok]), state)
    toks, _ = engine.greedy(torch.tensor([prompt[-1]]), state, n)
    return toks[0].tolist()


def test_step_slots_join_bit_identical_to_solo(engine):
    """A sequence admitted into a freed slot mid-flight decodes as it does
    alone (tests/test_decode_gateway.py for the hybrid state)."""
    S = 3
    state = engine.init_slot_state(S, 32)
    assert state.index.shape == (S,)
    feed = np.zeros((S,), np.int32)
    active = np.zeros((S,), bool)
    feed[0], active[0] = 3, True
    outs = []
    for step in range(9):
        if step == 4:
            free = np.zeros((S,), bool)
            free[1] = True
            state = engine.reset_slots(state, free)
            feed[1], active[1] = 7, True
        nxt, state = engine.step_slots(feed, state, active)
        nxt = np.asarray(nxt)
        feed = np.where(active, nxt, feed).astype(np.int32)
        outs.append(nxt.copy())
    outs = np.stack(outs)
    assert outs[:, 0].tolist() == _solo_tokens(engine, [3], 9)
    assert outs[4:, 1].tolist() == _solo_tokens(engine, [7], 5)


def test_step_slots_inactive_rows_frozen_and_reset(engine):
    """Masked-out rows keep state AND position; ``reset_slots`` zeroes a
    row's conv, ssm, kv, vv and position and leaves the others."""
    state = engine.init_slot_state(2, 16)
    feed = np.asarray([3, 7], np.int32)
    nxt, state = engine.step_slots(feed, state, np.ones((2,), bool))
    assert state.index.tolist() == [1, 1]
    row1 = [leaf[:, 1].clone() for leaf in state[:4]]
    only0 = np.asarray([True, False])
    for _ in range(2):
        nxt, state = engine.step_slots(np.asarray(nxt), state, only0)
    assert state.index.tolist() == [3, 1]
    for leaf, want in zip(state[:4], row1):
        assert torch.equal(leaf[:, 1], want)
    row0 = [leaf[:, 0].clone() for leaf in state[:4]]
    state = engine.reset_slots(state, np.asarray([False, True]))
    assert state.index.tolist() == [3, 0]
    for leaf, want in zip(state[:4], row0):
        assert not bool(leaf[:, 1].any()) and torch.equal(leaf[:, 0], want)


def test_prefill_slots_equals_stepping_token_by_token(engine):
    """Ragged chunked prefill under a row mask leaves the same state as
    stepping each row's prompt one token at a time."""
    S, C = 3, 4
    prompt = np.random.default_rng(9).integers(0, 256, size=(S, C)).astype(np.int32)
    lengths = np.array([4, 2, 3], np.int32)
    mask = np.array([True, True, False])
    a = engine.prefill_slots(prompt, lengths, engine.init_slot_state(S, 16), mask)
    b = engine.init_slot_state(S, 16)
    for t in range(C):
        engine.step_slots(prompt[:, t], b, mask & (t < lengths))
    assert a.index.tolist() == [4, 2, 0]
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_decode_programs_equal_eager_and_keep_the_state_leaves(models, monkeypatch):
    """prefill, greedy and sampled steps and a reset through the ``CPUGraph``
    double: every state leaf keeps its tensor (``data_ptr()``), the programs
    replay, and tokens and state equal the eager engine's to the bit."""
    monkeypatch.setattr(programs, "_graph_double", CPUGraph)
    _, _, cfg, params = models
    S, C = 3, 4
    engines = [DecodeEngine(params=params, cfg=cfg) for _ in range(2)]
    states = [e.init_slot_state(S, 16) for e in engines]
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
            state = eng.reset_slots(state, np.array([False, True, False]))
            feed, state = eng.step_slots(feed, state, np.ones(S, bool))
            toks[i].append(np.asarray(feed))
        states[i] = state
    assert [leaf.data_ptr() for leaf in states[0]] == ptrs
    assert (len(engines[0].programs), engines[0].programs.replays) == (3, 3)
    assert len(engines[1].programs) == 0
    for a, b in zip(*toks):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(*states):
        assert torch.equal(a, b)


@pytest.mark.parametrize("prefill_chunk", [0, 4])
def test_served_tokens_match_the_reference_gateway(models, prefill_chunk):
    """The same mixed request list through both gateways: the same tokens,
    slots and join steps, and the same counts."""
    jcfg, jparams, cfg, params = models
    spec = [([3, 7], 5), ([5], 3), ([9, 1, 4, 4, 2, 8], 4), ([2, 2], 6), ([11, 13, 6], 2)]
    kw = dict(max_slots=2, cache_slots=16, prefill_chunk=prefill_chunk)
    jgw = jdecode.DecodeGateway(jengine.DecodeEngine(params=jparams, cfg=jcfg), **kw)
    tgw = DecodeGateway(DecodeEngine(params=params, cfg=cfg), **kw)
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


_CPU = ["--arch", ARCH, "--device", "cpu"]


@pytest.fixture
def shared_weights(monkeypatch):
    """The port's launcher builds the reference launcher's weights (the
    reference initializer at the same seed, transferred)."""
    jcfg = jax_get_config(ARCH, smoke=True)
    tree = jax.tree.map(np.asarray, jmodel.init_params(jax.random.PRNGKey(0), jcfg))
    monkeypatch.setattr(tmodel, "init_params",
                        lambda gen, cfg, device: mamba2.params_from_jax(tree, cfg, device))


def test_serve_flow_matches_the_reference_launcher(shared_weights, monkeypatch, capsys):
    """Both launchers at the same flags, weights and conditioning, each
    request's noise from one numpy seed: latents within 2e-5 x NFE."""
    from repro.launch import serve as jserve

    noise = [_rand(1000 + r, (2, 20, 64)) for r in range(2)]
    got, want = [], []

    def fixed(store, to):
        def sample(self, batch, _rng):
            out = self.sample_from(batch, to(noise[len(store)]))
            store.append(out)
            return out
        return sample

    monkeypatch.setattr(JaxFlowSampler, "sample", fixed(want, jnp.asarray))
    monkeypatch.setattr(FlowSampler, "sample", fixed(got, lambda x: x))
    flags = ["--mode", "flow", "--nfe", "4", "--batch", "2", "--seq", "20", "--requests",
             "2", "--bns-iters", "0"]
    jserve.serve_flow(jserve.build_parser().parse_args(["--arch", ARCH] + flags))
    before = _launches()
    served = serve.main(_CPU + flags)
    assert _launches() == before
    assert "request 1: sampled (2, 20) in" in capsys.readouterr().out
    assert len(served) == len(got) == len(want) == 2
    for s, g, w in zip(served, got, want):
        assert s.nfe == 4 and s.latents is g and s.tokens.shape == (2, 20)
        _close(g, w, TOL * 4)
        assert int(s.tokens.min()) >= 0 and int(s.tokens.max()) < 256


def test_serve_decode_gateway_matches_the_reference_launcher(shared_weights, monkeypatch,
                                                             capsys):
    """Both launchers' decode gateways at the same flags and weights: every
    request finishes at its length with the same tokens; the same counts."""
    from repro.launch import serve as jserve

    futures = []
    real = jdecode.DecodeGateway.submit

    def submit(self, req):
        futures.append(real(self, req))
        return futures[-1]

    monkeypatch.setattr(jdecode.DecodeGateway, "submit", submit)
    flags = ["--mode", "decode", "--gateway", "--max-slots", "2", "--requests", "5",
             "--decode-lengths", "4,2", "--prefill-chunk", "4"]
    jserve.serve_decode(jserve.build_parser().parse_args(["--arch", ARCH] + flags))
    served = serve.main(_CPU + flags)
    assert "request 4: 4 tokens (length)" in capsys.readouterr().out
    assert [r.meta["new_tokens"] for r in served.responses] == [4, 2, 4, 2, 4]
    assert [r.tokens.tolist() for r in served.responses] == \
        [f.result().tokens.tolist() for f in futures]
    s = served.stats
    assert (s["completed"], s["failed"], s["tokens_out"]) == (5, 0, 16)


def test_serve_decode_refuses_a_paged_cache():
    with pytest.raises(TypeError, match="pageable"):
        serve.main(_CPU + ["--mode", "decode", "--gateway", "--page-size", "4"])


@pytest.mark.parametrize("extra", [["--bns-iters", "3"], []])     # the default is 300
def test_serve_takes_distillation_on_the_card_through_both_backwards(extra):
    """zamba2-2.7b distils on the card through gla_scan's backward and the
    flash backward at hd 80: the launcher refuses nothing for it, and
    without a card exits for the device alone."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA card")
    with pytest.raises(SystemExit) as exc:
        serve.main(["--arch", ARCH, "--device", "cuda"] + extra)
    msg = str(exc.value.code)
    assert "CUDA" in msg and "Queue B" not in msg


def test_serve_on_the_card_with_a_loaded_artifact_is_not_refused(tmp_path):
    """A saved artifact is loaded, not distilled, so the refusal stands
    aside; without a card the launcher then exits for the device."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA card")
    path = tmp_path / "solver.msgpack"
    path.write_bytes(b"")
    with pytest.raises(SystemExit) as exc:
        serve.main(["--arch", ARCH, "--device", "cuda", "--bns-iters", "3",
                    "--solver-artifact", str(path)])
    assert "Queue B" not in str(exc.value.code) and "CUDA" in str(exc.value.code)
