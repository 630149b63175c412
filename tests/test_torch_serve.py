"""The port's flow serving slice against the JAX reference, on the CPU:
``FlowSampler``, the synthetic tokens, latent decoding and the launcher.

yi-6b's smoke config in f32; the reference's params go through
``params_from_jax`` and the noise x0 is one numpy array handed to both
samplers. Tolerances are ``tests/test_kernels.py``'s f32 2e-5, scaled by NFE
for the solver's accumulated sum, as its ns_update cases scale by n.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import schedulers as jsched
from repro.data.synthetic import DataConfig as JaxDataConfig
from repro.data.synthetic import SyntheticTokens as JaxSyntheticTokens
from repro.models import model as jmodel
from repro.serving.engine import FlowSampler as JaxFlowSampler
from repro.serving.engine import nearest_latent_tokens as jax_nearest
from repro.solvers import registry as jreg
from repro_torch.configs import get_config
from repro_torch.core import schedulers as tsched
from repro_torch.data.synthetic import DataConfig, SyntheticTokens
from repro_torch.kernels.flash_attention import flash_attention as fa_mod
from repro_torch.kernels.ns_update import ns_update as nu_mod
from repro_torch.launch import serve
from repro_torch.models.transformer import params_from_jax
from repro_torch.serving.engine import FlowSampler, nearest_budget, nearest_latent_tokens
from repro_torch.solvers import registry as treg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 2e-5


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_get_config("yi-6b", smoke=True)
    jparams = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    cfg = get_config("yi-6b", smoke=True)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    tokens = JaxSyntheticTokens(jcfg, JaxDataConfig(batch_size=2, seq_len=12, seed=3)).batch(0)
    return jcfg, jparams, cfg, params, np.array(tokens["tokens"])


@pytest.mark.parametrize("name", ["euler", "midpoint"])
def test_sample_from_matches_reference(setup, name):
    jcfg, jparams, cfg, params, tok = setup
    x0 = np.random.default_rng(11).standard_normal((2, 12, cfg.latent_dim)).astype(np.float32)
    jsched_ = jsched.fm_ot()
    jsolver = jreg.build_ns(name, 4, jmodel.velocity_field(jparams, jcfg, jsched_))
    want = JaxFlowSampler(params=jparams, cfg=jcfg, sched=jsched_, solver=jsolver
                          ).sample_from({"tokens": jnp.asarray(tok)}, jnp.asarray(x0))
    sampler = FlowSampler(params=params, cfg=cfg, sched=tsched.fm_ot(),
                          solver=treg.build_ns(name, 4))
    before = (nu_mod.COUNTER.launches, fa_mod.COUNTER.launches)
    got = sampler.sample_from({"tokens": torch.from_numpy(tok)}, x0)
    assert (nu_mod.COUNTER.launches, fa_mod.COUNTER.launches) == before  # CPU: plain path
    assert got.dtype == torch.float32 and got.shape == x0.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL * 4, rtol=TOL * 4)
    assert sampler.budgets == (4,) and sampler.resolve_budget(4, strict=True) == 4
    with pytest.raises(ValueError):
        sampler.sample_from({"tokens": torch.from_numpy(tok)}, x0, budget=8)


def test_sample_draws_from_the_generator(setup):
    _, _, cfg, params, tok = setup
    sampler = FlowSampler(params=params, cfg=cfg, sched=tsched.fm_ot(),
                          solver=treg.build_ns("euler", 2))
    batch = {"tokens": torch.from_numpy(tok)}
    a = sampler.sample(batch, torch.Generator().manual_seed(1000))
    b = sampler.sample(batch, torch.Generator().manual_seed(1000))
    c = sampler.sample(batch, torch.Generator().manual_seed(1001))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.shape == (2, 12, cfg.latent_dim) and bool(torch.isfinite(a).all())


@pytest.mark.parametrize("seed,step", [(0, 0), (3, 1), (7, 5)])
def test_synthetic_tokens_are_bit_identical(seed, step):
    jtok = JaxSyntheticTokens(jax_get_config("yi-6b"), JaxDataConfig(3, 40, seed)).batch(step)
    ttok = SyntheticTokens(get_config("yi-6b"), DataConfig(3, 40, seed), device="cpu").batch(step)
    assert ttok["tokens"].dtype == torch.long
    np.testing.assert_array_equal(ttok["tokens"].numpy(), np.asarray(jtok["tokens"]))


def test_nearest_latent_tokens_matches_reference(setup):
    jcfg, jparams, cfg, params, _ = setup
    lat = np.random.default_rng(2).standard_normal((2, 9, cfg.latent_dim)).astype(np.float32)
    lat[0, :3] = np.asarray(jparams["flow"]["latent_embed"][np.array([5, 17, 200])])
    got = nearest_latent_tokens(params, torch.from_numpy(lat))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_nearest(jparams, jnp.asarray(lat))))
    assert got[0, :3].tolist() == [5, 17, 200]


def test_nearest_budget_rule():
    assert nearest_budget((4, 8, 16), 8) == 8
    assert nearest_budget((4, 8, 16), 6) == 4
    assert nearest_budget((4, 8, 16), 13) == 16
    with pytest.raises(ValueError):
        nearest_budget((4, 8), 6, strict=True)


def test_serve_main_answers_requests_on_cpu(capsys):
    served = serve.main(["--arch", "yi-6b", "--mode", "flow", "--smoke", "--nfe", "4",
                         "--batch", "2", "--seq", "8", "--requests", "2",
                         "--bns-iters", "0", "--device", "cpu"])
    assert len(served) == 2
    for s in served:
        assert s.nfe == 4 and s.latents.shape == (2, 8, 64) and s.tokens.shape == (2, 8)
        assert bool(torch.isfinite(s.latents).all())
        assert int(s.tokens.min()) >= 0 and int(s.tokens.max()) < 256
    out = capsys.readouterr().out
    assert "request 0: sampled (2, 8) in" in out and "(4 NFE)" in out


def _skip_with_a_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA card")


def test_serve_needs_a_card_unless_asked_for_the_cpu():
    _skip_with_a_card()
    with pytest.raises(SystemExit) as exc:
        serve.main(["--arch", "yi-6b", "--bns-iters", "0"])
    assert "CUDA" in str(exc.value.code)


def test_serve_cli_exit_code_without_a_card():
    _skip_with_a_card()
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                           "--arch", "yi-6b", "--bns-iters", "0"], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "CUDA" in proc.stderr


@pytest.mark.parametrize("extra,item", [
    (["--bns-iters", "300"], "ROADMAP Queue A item 0"),
    ([], "ROADMAP Queue A item 0"),                       # the reference's default
    (["--bns-iters", "0", "--solver-artifact", "s.msgpack"], "ROADMAP Queue A item 3"),
    (["--bns-iters", "0", "--budgets", "4,8"], "ROADMAP Queue A item 4"),
    (["--bns-iters", "0", "--gateway"], "ROADMAP Queue A item 7"),
    (["--bns-iters", "0", "--mode", "decode"], "ROADMAP Queue A item 9"),
])
def test_serve_refuses_what_it_does_not_serve(extra, item):
    with pytest.raises(SystemExit) as exc:
        serve.main(["--arch", "yi-6b", "--device", "cpu"] + extra)
    assert item in str(exc.value.code)
