"""The port's RWKV6 family against the JAX reference, on the CPU.

rwkv6-7b's smoke config (2 layers, d_model 128, two heads of 64, f32, chunk
16). The reference's params from ``init_params(PRNGKey(0), cfg)``, with the
bonus ``u``, the decay bias ``w0``, the mixes ``mu`` and ``ln_x`` redrawn from
a numpy seed so that every term of the time mix is live (the reference's
initial ``u`` is 0 and its decay e^-6 is nearly none), go to both sides as
numpy. Inputs and noise are made with numpy from a seed. Tolerances are
``tests/test_kernels.py``'s (f32 2e-5, bf16 2e-2), scaled by NFE for the
solver's accumulated sum, as ``tests/test_torch_serve.py`` scales them.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import schedulers as jsched
from repro.models import model as jmodel
from repro.models import rwkv6 as jrwkv
from repro.serving import decode as jdecode
from repro.serving import engine as jengine
from repro.serving.engine import FlowSampler as JaxFlowSampler
from repro.solvers import registry as jreg
from repro_torch.configs import get_config
from repro_torch.core import schedulers as tsched
from repro_torch.kernels.gla_scan import gla_scan as gs_mod
from repro_torch.kernels.ns_update import ns_update as nu_mod
from repro_torch.launch import serve
from repro_torch.models import model as tmodel
from repro_torch.models import rwkv6
from repro_torch.serving.decode import DecodeGateway, DecodeRequest
from repro_torch.serving.engine import DecodeEngine, FlowSampler
from repro_torch.solvers import registry as treg

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
ARCH = "rwkv6-7b"


def _live(tree: dict, seed: int) -> dict:
    """The reference tree (numpy) with u, w0, mu and ln_x redrawn."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.array, tree)
    tm = tree["layers"]["tm"]
    for key, fn in (("u", lambda s: 0.5 * rng.standard_normal(s)),
                    ("w0", lambda s: -1.0 + 0.5 * rng.standard_normal(s)),
                    ("mu", lambda s: rng.uniform(0.0, 1.0, s)),
                    ("ln_x", lambda s: 1.0 + 0.1 * rng.standard_normal(s))):
        tm[key] = fn(tm[key].shape).astype(tm[key].dtype)
    tree["layers"]["cm"]["mu"] = rng.uniform(0.0, 1.0, tree["layers"]["cm"]["mu"].shape
                                             ).astype(np.float32)
    return tree


@pytest.fixture(scope="module")
def models():
    jcfg = jax_get_config(ARCH, smoke=True)
    tree = _live(jmodel.init_params(jax.random.PRNGKey(0), jcfg), 0)
    jparams = jax.tree.map(jnp.asarray, tree)
    cfg = get_config(ARCH, smoke=True)
    return jcfg, jparams, cfg, rwkv6.params_from_jax(tree, cfg, device="cpu")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


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


def test_config_is_the_reference_config():
    for smoke in (True, False):
        assert dataclasses.asdict(get_config(ARCH, smoke=smoke)) == \
            dataclasses.asdict(jax_get_config(ARCH, smoke=smoke))
    full = get_config(ARCH)
    assert (full.family, full.n_layers, full.d_model, full.d_model // rwkv6.HEAD_DIM,
            full.d_ff, full.vocab, full.ssm.chunk, full.dtype) == \
        ("ssm", 32, 4096, 64, 14336, 65536, 64, "bfloat16")
    assert full.param_count() == jax_get_config(ARCH).param_count()


def test_params_from_jax_is_a_transfer(models):
    jcfg, jparams, cfg, params = models
    flat = dict(_flatten(params))
    for path, leaf in jax.tree_util.tree_flatten_with_path(jparams)[0]:
        t = flat[".".join(k.key for k in path)]
        assert tuple(t.shape) == leaf.shape
        assert str(t.dtype).removeprefix("torch.") == str(leaf.dtype)
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))
    assert len(flat) == len(jax.tree.leaves(jparams))


def test_params_from_jax_takes_only_the_rwkv_tree(models):
    jcfg, jparams, cfg, _ = models
    tree = jax.tree.map(np.asarray, jparams)
    with pytest.raises(ValueError, match="layer tree"):
        rwkv6.params_from_jax({**tree, "layers": {"attn": {}, "mlp": {}}}, cfg, device="cpu")
    with pytest.raises(ValueError, match="param tree"):
        rwkv6.params_from_jax({k: v for k, v in tree.items() if k != "lm_head"}, cfg,
                              device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_rwkv_params_has_the_reference_tree(dtype):
    """Same keys, shapes and dtypes as the reference initializer under
    ``cast_params``' rule (only the 1-D final norm stays f32 in bf16); the
    random draws differ, their scales match."""
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
    assert ours["final_norm"].dtype == torch.float32
    assert ours["layers.tm.w0"].dtype == getattr(torch, dtype)
    for key in ("layers.tm.w0", "layers.tm.u", "layers.tm.mu", "layers.tm.ln_x",
                "layers.norm1"):
        np.testing.assert_array_equal(_np(ours[key]), np.asarray(ref[key], np.float32))
    w = ours["layers.cm.wk"].float()
    assert abs(float(w.std()) - cfg.d_model ** -0.5) < 0.1 * cfg.d_model ** -0.5


def test_decay_is_f32_and_non_positive(models):
    _, _, cfg, params = models
    p = {k: v[0] for k, v in params["layers"]["tm"].items()}
    ld = rwkv6._decay({k: v.bfloat16() for k, v in p.items()},
                      torch.from_numpy(_rand(1, (2, 5, cfg.d_model))).bfloat16())
    assert ld.dtype == torch.float32 and bool((ld <= 0).all())


@pytest.mark.parametrize("L", [32, 20])         # a multiple of the chunk (16), and not
@pytest.mark.parametrize("t", [0.0, 0.6])
def test_velocity(models, L, t):
    jcfg, jparams, cfg, params = models
    x = _rand(4 + L, (2, L, cfg.latent_dim))
    tok = _tokens(5, 2, L, cfg.vocab)
    want = jmodel.velocity(jparams, jcfg, jnp.float32(t), jnp.asarray(x),
                           {"tokens": jnp.asarray(tok, jnp.int32)})
    before = gs_mod.COUNTER.launches
    got = tmodel.velocity(params, cfg, torch.tensor(t), torch.from_numpy(x),
                          {"tokens": torch.from_numpy(tok)})
    assert gs_mod.COUNTER.launches == before                  # CPU: the plain route
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), _np(want), atol=TOL["float32"],
                               rtol=TOL["float32"])


def test_velocity_unconditional_branch(models):
    jcfg, jparams, cfg, params = models
    x = _rand(6, (2, 24, cfg.latent_dim))
    want = jmodel.velocity(jparams, jcfg, jnp.float32(0.3), jnp.asarray(x), None)
    got = tmodel.velocity(params, cfg, torch.tensor(0.3), torch.from_numpy(x), None)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=TOL["float32"],
                               rtol=TOL["float32"])


@pytest.mark.parametrize("L", [16, 12])
def test_sample_from_matches_reference(models, L):
    jcfg, jparams, cfg, params = models
    tok = _tokens(3, 2, L, cfg.vocab)
    x0 = _rand(11, (2, L, cfg.latent_dim))
    js = jsched.fm_ot()
    jsolver = jreg.build_ns("euler", 4, jmodel.velocity_field(jparams, jcfg, js))
    want = JaxFlowSampler(params=jparams, cfg=jcfg, sched=js, solver=jsolver
                          ).sample_from({"tokens": jnp.asarray(tok)}, jnp.asarray(x0))
    sampler = FlowSampler(params=params, cfg=cfg, sched=tsched.fm_ot(),
                          solver=treg.build_ns("euler", 4))
    before = (nu_mod.COUNTER.launches, gs_mod.COUNTER.launches)
    got = sampler.sample_from({"tokens": torch.from_numpy(tok)}, x0)
    assert (nu_mod.COUNTER.launches, gs_mod.COUNTER.launches) == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL["float32"] * 4,
                               rtol=TOL["float32"] * 4)


def test_decode_logits_and_greedy_tokens_match_reference(models):
    """Several steps of the reference's decode_step (scalar index) and the
    port's, fed the reference's greedy tokens: logits within f32 TOL, the same
    argmax, the same state."""
    jcfg, jparams, cfg, params = models
    jstate = jrwkv.init_state(jcfg, 3)
    state = tmodel.init_decode_state(cfg, 3, 0, device="cpu")
    assert isinstance(state, rwkv6.RWKVState) and state.wkv.dtype == torch.float32
    tok = np.array([3, 7, 200], np.int32)
    for step in range(6):
        jl, jstate = jrwkv.decode_step(jparams, jcfg, jnp.asarray(tok), jstate)
        tl, state = tmodel.decode_apply(params, cfg, torch.from_numpy(tok), state)
        np.testing.assert_allclose(tl.numpy(), _np(jl), atol=TOL["float32"],
                                   rtol=TOL["float32"], err_msg=f"step {step}")
        nxt = np.array(jnp.argmax(jl, -1), np.int32)
        assert torch.argmax(tl, -1).numpy().tolist() == nxt.tolist()
        tok = nxt
    assert int(state.index) == 6
    for got, want in zip(state[:3], jstate[:3]):
        np.testing.assert_allclose(_np(got), _np(want), atol=TOL["float32"],
                                   rtol=TOL["float32"])


def test_decode_step_writes_only_active_rows(models):
    """``active`` picks the rows a step advances: the others keep every bit of
    shift_tm, shift_cm and wkv, and their position."""
    _, _, cfg, params = models
    state = tmodel.init_decode_state(cfg, 3, 0, device="cpu")
    state = state._replace(index=torch.zeros((3,), dtype=torch.int32))
    tok = torch.tensor([3, 7, 9])
    _, state = tmodel.decode_apply(params, cfg, tok, state)
    frozen = [leaf[:, 1].clone() for leaf in state[:3]]
    active = torch.tensor([True, False, True])
    for _ in range(2):
        _, state = tmodel.decode_apply(params, cfg, tok, state, active=active)
    assert state.index.tolist() == [3, 1, 3]
    for leaf, before in zip(state[:3], frozen):
        assert torch.equal(leaf[:, 1], before)
    assert not torch.equal(state.wkv[:, 0], state.wkv[:, 1])


def test_decode_state_batch_axes_and_no_paged_state():
    cfg = get_config(ARCH, smoke=True)
    axes = rwkv6.RWKVState(shift_tm=1, shift_cm=1, wkv=1, index=0)
    assert tmodel.decode_state_batch_axes(cfg) == axes
    assert tmodel.decode_state_batch_axes(cfg, paged=True) == axes
    with pytest.raises(TypeError, match="paged KV cache not supported"):
        tmodel.init_paged_decode_state(cfg, 2, 8, 4, 2, device="cpu")


@pytest.fixture(scope="module")
def engine(models):
    _, _, cfg, params = models
    return DecodeEngine(params=params, cfg=cfg)


def _solo_tokens(engine, prompt, n):
    """Teacher-force ``prompt`` through the plain scalar-index decode path,
    then greedy — independent of the slot machinery."""
    state = engine.init_state(1, 32)
    for tok in prompt[:-1]:
        _, state = engine.step(torch.tensor([tok]), state)
    toks, _ = engine.greedy(torch.tensor([prompt[-1]]), state, n)
    return toks[0].tolist()


def test_step_slots_join_bit_identical_to_solo(engine):
    """tests/test_decode_gateway.py for rwkv6: a sequence admitted into a
    freed slot mid-flight decodes bit-identically to decoding it alone."""
    S = 3
    state = engine.init_slot_state(S, 32)
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


def test_step_slots_inactive_rows_frozen(engine):
    """Masked-out rows keep state AND position; re-activating them resumes."""
    state = engine.init_slot_state(2, 16)
    feed = np.asarray([3, 7], np.int32)
    nxt, state = engine.step_slots(feed, state, np.ones((2,), bool))
    assert state.index.tolist() == [1, 1]
    row1 = [leaf[:, 1].clone() for leaf in (state.shift_tm, state.shift_cm, state.wkv)]
    only0 = np.asarray([True, False])
    for _ in range(2):
        nxt, state = engine.step_slots(np.asarray(nxt), state, only0)
    assert state.index.tolist() == [3, 1]
    for got, want in zip((state.shift_tm, state.shift_cm, state.wkv), row1):
        assert torch.equal(got[:, 1], want)


@pytest.mark.parametrize("prefill_chunk", [0, 4])
def test_served_tokens_match_the_reference_gateway(models, prefill_chunk):
    """The same mixed request list through both gateways (page_size given: a
    no-op for the ssm family on both sides): the same tokens, slots and join
    steps."""
    jcfg, jparams, cfg, params = models
    spec = [([3, 7], 5), ([5], 3), ([9, 1, 4, 4, 2, 8], 4), ([2, 2], 6), ([11, 13, 6], 2)]
    kw = dict(max_slots=2, cache_slots=16, prefill_chunk=prefill_chunk)
    jgw = jdecode.DecodeGateway(jengine.DecodeEngine(params=jparams, cfg=jcfg, page_size=4),
                                **kw)
    tgw = DecodeGateway(DecodeEngine(params=params, cfg=cfg, page_size=4), **kw)
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


def test_serve_flow_on_cpu(capsys):
    before = gs_mod.COUNTER.launches
    served = serve.main(_CPU + ["--mode", "flow", "--nfe", "4", "--batch", "2", "--seq",
                                "20", "--requests", "2", "--bns-iters", "0"])
    assert gs_mod.COUNTER.launches == before
    assert len(served) == 2
    for s in served:
        assert s.nfe == 4 and s.latents.shape == (2, 20, 64) and s.tokens.shape == (2, 20)
        assert bool(torch.isfinite(s.latents).all())
        assert int(s.tokens.min()) >= 0 and int(s.tokens.max()) < 256
    assert "request 1: sampled (2, 20) in" in capsys.readouterr().out


def test_serve_decode_gateway_on_cpu(capsys):
    """--page-size is a no-op for the ssm family; every request finishes at
    its length with in-vocabulary tokens."""
    served = serve.main(_CPU + ["--mode", "decode", "--gateway", "--page-size", "4",
                                "--max-slots", "2", "--requests", "5",
                                "--decode-lengths", "4,2", "--prefill-chunk", "4"])
    assert [r.meta["new_tokens"] for r in served.responses] == [4, 2, 4, 2, 4]
    for r in served.responses:
        assert r.meta["finish_reason"] == "length"
        assert all(0 <= t < 256 for t in r.tokens.tolist())
    s = served.stats
    assert (s["completed"], s["failed"], s["tokens_out"]) == (5, 0, 16)
    assert "pages_in_use" not in s
    assert "request 4: 4 tokens (length)" in capsys.readouterr().out


def test_serve_decode_greedy_demo_on_cpu(capsys):
    served = serve.main(_CPU + ["--mode", "decode", "--batch", "2", "--steps", "5"])
    assert served.tokens.shape == (2, 5) and served.tokens.dtype == torch.int32
    assert "decoded 5 tokens x 2 seqs" in capsys.readouterr().out


def test_serve_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA card")
    with pytest.raises(SystemExit) as exc:
        serve.main(["--arch", ARCH, "--mode", "decode", "--steps", "2"])
    assert "CUDA" in str(exc.value.code)
