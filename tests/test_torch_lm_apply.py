"""``model.lm_apply`` (full-sequence train / prefill logits) for the six
families against the reference's, and the parametrization converters.

Each family's smoke model (f32) takes the reference's params from
``init_params(PRNGKey(0), cfg)`` as numpy, with the norms (and rwkv6's and
mamba2's per-head constants, which the reference initializes flat) redrawn
from a numpy seed so every term is live, as the family's own parity file
does. Tokens, frames and patches are made with numpy. Each family is held
at the tolerance of its own velocity parity test: f32 2e-5
(``tests/test_kernels.py``) for rwkv6 and zamba2, and 4 x 2e-5 through the
attention of the dense, moe, encdec and vlm families.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import parametrization as jparam
from repro.core import schedulers as jsched
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro_torch.configs import get_config
from repro_torch.core import parametrization as tparam
from repro_torch.core import schedulers as tsched
from repro_torch.models import mamba2, moe, rwkv6, transformer, vlm, whisper
from repro_torch.models import model as tmodel

TOL = 2e-5                       # tests/test_kernels.py, f32
# arch -> (the family module's params_from_jax, the family parity test's tolerance)
ARCHS = {"yi-6b": (transformer, TOL * 4), "qwen3-moe-30b-a3b": (moe, TOL * 4),
         "rwkv6-7b": (rwkv6, TOL), "zamba2-2.7b": (mamba2, TOL),
         "whisper-medium": (whisper, TOL * 4), "internvl2-26b": (vlm, TOL * 4)}
S = 16


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol, **kw):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol, **kw)


def _live(tree, rng):
    """The numpy tree with every ``norm*`` leaf redrawn near 1, and rwkv6's
    (u, w0, mu, ln_x) and mamba2's (A_log, D, dt_bias) constants redrawn as
    ``test_torch_rwkv6.py`` and ``test_torch_mamba2.py`` redraw them."""
    draws = {"u": lambda s: 0.5 * rng.standard_normal(s),
             "w0": lambda s: -1.0 + 0.5 * rng.standard_normal(s),
             "mu": lambda s: rng.uniform(0.0, 1.0, s),
             "ln_x": lambda s: 1.0 + 0.1 * rng.standard_normal(s),
             "A_log": lambda s: 0.5 * rng.standard_normal(s),
             "D": lambda s: 1.0 + 0.5 * rng.standard_normal(s),
             "dt_bias": lambda s: -2.0 + rng.standard_normal(s)}
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _live(v, rng)
        elif "norm" in k:
            out[k] = (1.0 + 0.1 * rng.standard_normal(v.shape)).astype(v.dtype)
        elif k in draws:
            out[k] = draws[k](v.shape).astype(v.dtype)
        else:
            out[k] = v
    return out


@pytest.fixture(scope="module", params=list(ARCHS))
def family(request):
    arch = request.param
    module, tol = ARCHS[arch]
    jcfg = jax_get_config(arch, smoke=True)
    tree = jax.tree.map(np.asarray, jmodel.init_params(jax.random.PRNGKey(0), jcfg))
    tree = _live(tree, np.random.default_rng(1))
    cfg = get_config(arch, smoke=True)
    rng = np.random.default_rng(2)
    batch = {"tokens": rng.integers(0, cfg.vocab, size=(2, S))}
    if cfg.family == "encdec":
        batch["frames"] = (0.05 * rng.standard_normal(
            (2, cfg.frontend.num_tokens, cfg.d_model))).astype(np.float32)
    if cfg.family == "vlm":
        batch["patches"] = (0.05 * rng.standard_normal(
            (2, cfg.frontend.num_tokens, cfg.frontend.embed_dim))).astype(np.float32)
    jbatch = {k: jnp.asarray(v, jnp.int32 if k == "tokens" else jnp.float32)
              for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    return (jcfg, jax.tree.map(jnp.asarray, tree), jbatch, cfg,
            module.params_from_jax(tree, cfg, device="cpu"), tbatch, tol)


@pytest.mark.parametrize("last_only", [False, True])
def test_lm_apply_matches_the_reference(family, last_only):
    """The logits of every position (or the last one's), shape and values."""
    jcfg, jparams, jbatch, cfg, params, batch, tol = family
    want = jmodel.lm_apply(jparams, jcfg, jbatch, last_only=last_only)
    got = tmodel.lm_apply(params, cfg, batch, last_only=last_only)
    prefix = cfg.frontend.num_tokens if cfg.family == "vlm" else 0
    assert tuple(got.shape) == tuple(want.shape) == (2, 1 if last_only else prefix + S,
                                                      cfg.vocab)
    assert got.dtype == torch.float32
    _close(got, want, tol)


def test_last_only_is_the_full_calls_last_row(family):
    """``last_only`` slices before the projection: the same last row."""
    _, _, _, cfg, params, batch, tol = family
    full = tmodel.lm_apply(params, cfg, batch)
    _close(tmodel.lm_apply(params, cfg, batch, last_only=True), full[:, -1:], tol)


@pytest.mark.parametrize("window", [3, 8])
def test_dense_window_matches_the_reference(window):
    """Sliding-window attention on the CPU (the card's windowed route is
    the same plain path, ``tests/test_torch_window.py``): the reference's
    logits, and not the full-attention ones."""
    jcfg = jax_get_config("yi-6b", smoke=True)
    tree = _live(jax.tree.map(np.asarray, jmodel.init_params(jax.random.PRNGKey(0), jcfg)),
                 np.random.default_rng(1))
    cfg = get_config("yi-6b", smoke=True)
    params = transformer.params_from_jax(tree, cfg, device="cpu")
    tok = np.random.default_rng(3).integers(0, cfg.vocab, size=(2, S))
    want = jmodel.lm_apply(jax.tree.map(jnp.asarray, tree), jcfg,
                           {"tokens": jnp.asarray(tok, jnp.int32)}, window=window)
    got = tmodel.lm_apply(params, cfg, {"tokens": torch.from_numpy(tok)}, window=window)
    _close(got, want, TOL * 4)
    full = tmodel.lm_apply(params, cfg, {"tokens": torch.from_numpy(tok)})
    assert not torch.allclose(got[:, window:], full[:, window:], atol=1e-3)
    torch.testing.assert_close(got[:, :window], full[:, :window], atol=TOL * 4, rtol=TOL * 4)


def test_moe_aux_matches_the_reference():
    """``moe.lm_forward``'s second output: the mean router aux loss."""
    jcfg = jax_get_config("qwen3-moe-30b-a3b", smoke=True)
    tree = _live(jax.tree.map(np.asarray, jmodel.init_params(jax.random.PRNGKey(0), jcfg)),
                 np.random.default_rng(1))
    cfg = get_config("qwen3-moe-30b-a3b", smoke=True)
    params = moe.params_from_jax(tree, cfg, device="cpu")
    tok = np.random.default_rng(4).integers(0, cfg.vocab, size=(2, S))
    want_logits, want_aux = jmoe.lm_forward(jax.tree.map(jnp.asarray, tree), jcfg,
                                            jnp.asarray(tok, jnp.int32))
    logits, aux = moe.lm_forward(params, cfg, torch.from_numpy(tok))
    assert aux.shape == () and aux.dtype == torch.float32 and float(aux) > 0
    _close(aux, want_aux, TOL * 4)
    _close(logits, want_logits, TOL * 4)


@pytest.mark.parametrize("sched", ["fm_ot", "fm_cs", "vp"])
def test_eps_and_x_to_velocity_match_the_reference(sched):
    rng = np.random.default_rng(5)
    t = rng.uniform(0.05, 0.95, (4, 1, 1)).astype(np.float32)
    x, f = (rng.standard_normal((4, 6, 3)).astype(np.float32) for _ in "xf")
    js, ts = getattr(jsched, sched)(), getattr(tsched, sched)()
    for jfn, tfn in ((jparam.eps_to_velocity, tparam.eps_to_velocity),
                     (jparam.x_to_velocity, tparam.x_to_velocity)):
        want = jfn(js, jnp.asarray(t), jnp.asarray(x), jnp.asarray(f))
        got = tfn(ts, torch.from_numpy(t), torch.from_numpy(x), torch.from_numpy(f))
        _close(got, want, TOL, err_msg=tfn.__name__)
