"""The port's dense flow backbone against the JAX reference, on the CPU.

yi-6b's smoke config (2 layers, d_model 256, f32). The reference's params
from ``init_params(PRNGKey(0), cfg)`` go through ``params_from_jax``; inputs
are made with numpy from a seed and handed to both sides. Tolerances are
``tests/test_kernels.py``'s (f32 2e-5, bf16 2e-2); where a case loosens one,
it says why.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import schedulers as jsched
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro_torch.configs import get_config
from repro_torch.core import schedulers as tsched
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel
from repro_torch.models.transformer import init_dense_params, params_from_jax

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


@pytest.fixture(scope="module")
def cfg():
    return get_config("yi-6b", smoke=True)


@pytest.fixture(scope="module")
def jax_params(cfg):
    return jmodel.init_params(jax.random.PRNGKey(0), jax_get_config("yi-6b", smoke=True))


@pytest.fixture(scope="module")
def params(cfg, jax_params):
    return params_from_jax(jax.tree.map(np.asarray, jax_params), cfg, device="cpu")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rand(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _tokens(seed, B, S, vocab):
    return np.random.default_rng(seed).integers(0, vocab, size=(B, S))


def test_config_is_the_reference_config(cfg):
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jax_get_config("yi-6b", smoke=True))
    full = get_config("yi-6b")
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
            full.resolved_head_dim, full.d_ff, full.vocab, full.dtype) == \
        (32, 4096, 32, 4, 128, 11008, 64000, "bfloat16")
    assert full.param_count() == jax_get_config("yi-6b").param_count()


def test_params_from_jax_is_a_transfer(cfg, jax_params, params):
    jflat = jax.tree_util.tree_flatten_with_path(jax_params)[0]
    for path, leaf in jflat:
        t = params
        for key in path:
            t = t[key.key]
        assert tuple(t.shape) == leaf.shape
        assert str(t.dtype).removeprefix("torch.") == str(leaf.dtype)
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))


def test_init_dense_params_has_the_reference_tree(cfg, jax_params):
    """Same keys, shapes and dtypes as the reference initializer (the random
    draws differ: torch generators are not JAX keys)."""
    ours = init_dense_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    ref = params_from_jax(jax.tree.map(np.asarray, jax_params), cfg, device="cpu")
    flat_ours = dict(_flatten(ours))
    flat_ref = dict(_flatten(ref))
    assert flat_ours.keys() == flat_ref.keys()
    for k, v in flat_ref.items():
        assert flat_ours[k].shape == v.shape and flat_ours[k].dtype == v.dtype, k
    w = flat_ours["layers.mlp.w_gate"]
    assert abs(float(w.std()) - cfg.d_model ** -0.5) < 0.1 * cfg.d_model ** -0.5


def _flatten(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + k + ".")
        else:
            yield prefix + k, v


def test_init_params_on_cuda_without_a_card_raises(cfg):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA card")
    with pytest.raises(RuntimeError, match="CUDA"):
        tmodel.init_params(torch.Generator().manual_seed(0), cfg)


def test_rms_norm():
    x, w = _rand(0, (2, 5, 256)), _rand(1, (256,))
    got = tlayers.rms_norm(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), _np(jlayers.rms_norm(jnp.asarray(x), jnp.asarray(w))),
                               atol=TOL["float32"], rtol=TOL["float32"])


@pytest.mark.parametrize("offset", [0, 1000])
def test_apply_rope(offset):
    x = _rand(2, (2, 7, 4, 32))
    pos = np.arange(offset, offset + 7)
    got = tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 5e6)
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 5e6)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=TOL["float32"],
                               rtol=TOL["float32"])


@pytest.mark.parametrize("t", [0.0, 0.37, np.array([0.0, 0.5, 0.97], np.float32)])
def test_timestep_embedding(t):
    got = tlayers.timestep_embedding(torch.as_tensor(t), 256)
    want = jlayers.timestep_embedding(jnp.asarray(t), 256)
    assert got.shape == want.shape
    # ang = t * freq * 1000 reaches ~1e3 rad, where one f32 ulp of the angle
    # is 6.1e-5 and moves cos/sin by up to as much (the two frameworks' exp
    # round freq differently in the last bit): the f32 atol is 5x TOL for that.
    np.testing.assert_allclose(got.numpy(), _np(want), atol=5 * TOL["float32"])


@pytest.mark.parametrize("name", ["fm_ot", "fm_cs", "vp", "ve"])
def test_scheduler_calculus(name):
    t = np.linspace(0.05, 0.95, 7).astype(np.float32)
    js, ts = jsched.get_scheduler(name), tsched.get_scheduler(name)
    jt, tt = jnp.asarray(t), torch.from_numpy(t)
    for fn in ("alpha", "sigma", "dalpha", "dsigma", "snr"):
        np.testing.assert_allclose(getattr(ts, fn)(tt).numpy(), _np(getattr(js, fn)(jt)),
                                   atol=TOL["float32"], rtol=TOL["float32"], err_msg=fn)
    v = np.array(js.snr(jt))
    np.testing.assert_allclose(ts.snr_inverse(torch.from_numpy(v)).numpy(),
                               _np(js.snr_inverse(jnp.asarray(v))),
                               atol=TOL["float32"], rtol=TOL["float32"])


def test_attention_forward(cfg, jax_params, params):
    x = _rand(3, (2, 16, cfg.d_model))
    kw = dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.resolved_head_dim,
              rope_theta=cfg.rope_theta)
    jp = jax.tree.map(lambda a: a[0], jax_params["layers"]["attn"])
    tp = {k: v[0] for k, v in params["layers"]["attn"].items()}
    for causal in (True, False):
        want = jattn.attention_forward(jp, jnp.asarray(x), jnp.arange(16), causal=causal, **kw)
        got = tattn.attention_forward(tp, torch.from_numpy(x), torch.arange(16),
                                      causal=causal, **kw)
        np.testing.assert_allclose(got.numpy(), _np(want), atol=TOL["float32"],
                                   rtol=TOL["float32"])


@pytest.mark.parametrize("t", [0.0, 0.5, 0.97])
def test_velocity(cfg, jax_params, params, t):
    x = _rand(4, (2, 12, cfg.latent_dim))
    tok = _tokens(5, 2, 12, cfg.vocab)
    want = jmodel.velocity(jax_params, jax_get_config("yi-6b", smoke=True), jnp.float32(t),
                           jnp.asarray(x), {"tokens": jnp.asarray(tok, jnp.int32)})
    got = tmodel.velocity(params, cfg, torch.tensor(t), torch.from_numpy(x),
                          {"tokens": torch.from_numpy(tok)})
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), _np(want), atol=TOL["float32"], rtol=TOL["float32"])


def test_velocity_field_with_cfg(cfg, jax_params, params):
    x = _rand(6, (2, 12, cfg.latent_dim))
    tok = _tokens(7, 2, 12, cfg.vocab)
    jcfg = jax_get_config("yi-6b", smoke=True)
    jf = jmodel.velocity_field(jax_params, jcfg, jsched.fm_ot(),
                               {"tokens": jnp.asarray(tok, jnp.int32)}, cfg_scale=0.5)
    tf = tmodel.velocity_field(params, cfg, tsched.fm_ot(),
                               {"tokens": torch.from_numpy(tok)}, cfg_scale=0.5)
    np.testing.assert_allclose(tf(torch.tensor(0.25), torch.from_numpy(x)).numpy(),
                               _np(jf(jnp.float32(0.25), jnp.asarray(x))),
                               atol=TOL["float32"], rtol=TOL["float32"])


def test_velocity_bf16(cfg):
    """The smoke config in bf16: bf16 weights and activations on both sides.
    The two frameworks round bf16 at the same places here but order their
    matmul sums differently; the bf16 tolerance holds."""
    bcfg = dataclasses.replace(cfg, dtype="bfloat16")
    jcfg = dataclasses.replace(jax_get_config("yi-6b", smoke=True), dtype="bfloat16")
    jp = jmodel.init_params(jax.random.PRNGKey(1), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), bcfg, device="cpu")
    assert tp["layers"]["mlp"]["w_up"].dtype == torch.bfloat16
    assert tp["final_norm"].dtype == torch.float32
    x = _rand(8, (2, 12, cfg.latent_dim))
    tok = _tokens(9, 2, 12, cfg.vocab)
    want = jmodel.velocity(jp, jcfg, jnp.float32(0.5), jnp.asarray(x),
                           {"tokens": jnp.asarray(tok, jnp.int32)})
    got = tmodel.velocity(tp, bcfg, torch.tensor(0.5), torch.from_numpy(x),
                          {"tokens": torch.from_numpy(tok)})
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _np(want), atol=TOL["bfloat16"],
                               rtol=TOL["bfloat16"])


def test_unported_family_names_its_roadmap_item(cfg):
    moe = dataclasses.replace(cfg, family="moe")
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A item 10"):
        tmodel.init_params(torch.Generator().manual_seed(0), moe, device="cpu")
