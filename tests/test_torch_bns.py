"""BNS distillation (Algorithm 2) in the port against ``repro.core.bns``, on
the CPU.

Both frameworks start from one theta0 (built by each registry from the same
solver, checked equal) and one set of (x0, x1) pairs: x0 made with numpy from
a seed, x1 the reference's RK45 solve of it, handed to both as numpy. The
toy field is the two-moons Gaussian mixture of ``tests/test_bns.py``; the
backbone is yi-6b's smoke config with the reference's params exported.
Tolerances are ``tests/test_kernels.py``'s f32 2e-5 unless a case says why.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import bns as jbns
from repro.core import ns_solver as jns
from repro.core import schedulers as jsched
from repro.core import toy as jtoy
from repro.core.rk45 import rk45_solve as jax_rk45
from repro.models import model as jmodel
from repro.solvers import registry as jreg
from repro_torch.configs import get_config
from repro_torch.core import bns as tbns
from repro_torch.core import ns_solver as tns
from repro_torch.core import schedulers as tsched
from repro_torch.core import toy as ttoy
from repro_torch.core.rk45 import rk45_solve
from repro_torch.kernels.flash_attention import flash_attention as fa_mod
from repro_torch.kernels.ns_update import ns_update as nu_mod
from repro_torch.launch import serve
from repro_torch.models import model as tmodel
from repro_torch.models.transformer import params_from_jax
from repro_torch.solvers import registry as treg

TOL = 2e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These tests run thousands of tiny eager ops (RK45 steps, training
    iterations); beside other test workers, torch's intra-op threads only
    contend for the cores, so each test runs on one and restores the count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def toy():
    jfield = jtoy.mixture_field(jsched.fm_ot(), jtoy.two_moons_means(),
                                jnp.full((16,), 0.15), jnp.ones((16,)))
    tfield = ttoy.mixture_field(tsched.fm_ot(), ttoy.two_moons_means(),
                                torch.full((16,), 0.15), torch.ones((16,)))
    solve = jax.jit(lambda x: jax_rk45(jfield.fn, x, rtol=1e-5, atol=1e-5).x1)
    pairs = []
    for seed in (0, 1):
        x0 = np.random.default_rng(seed).standard_normal((128, 2)).astype(np.float32)
        pairs.append((x0, np.asarray(solve(jnp.asarray(x0)))))
    return jfield, tfield, pairs[0], pairs[1]


def _jpairs(p):
    return tuple(jnp.asarray(a) for a in p)


def _tpairs(p):
    return tuple(torch.from_numpy(a) for a in p)


def _theta0(name, nfe):
    jt = jns.from_ns(jreg.build_ns(name, nfe, None))
    tt = tns.from_ns(treg.build_ns(name, nfe, None))
    for a, b in zip(jt, tt):
        np.testing.assert_allclose(_np(b), np.asarray(a), rtol=1e-6, atol=1e-7)
    return jt, tns.bns_params_from_numpy(*(np.asarray(x) for x in jt))


@pytest.mark.parametrize("max_val", [1.0, 2.0])
def test_psnr_matches_reference(max_val):
    rng = np.random.default_rng(3)
    x, ref = rng.standard_normal((2, 6, 5, 3)).astype(np.float32)
    ref[0] = x[0]                        # an exact pair: mse floored at 1e-20
    got = tbns.psnr(torch.from_numpy(x), torch.from_numpy(ref), max_val)
    want = jbns.psnr(jnp.asarray(x), jnp.asarray(ref), max_val)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=TOL)


@pytest.mark.parametrize("nfe", [4, 8])
@pytest.mark.parametrize("init", ["euler", "midpoint"])
def test_loss_and_gradient_match_reference_on_the_toy_field(toy, nfe, init):
    """_loss_fn and its gradient in (time_logits, a, b) against
    jax.value_and_grad. rtol 1e-4 on the gradient: it sums NFE
    back-propagated steps of the f32 mixture field, whose softmax
    responsibilities the two frameworks reduce in different orders."""
    jfield, tfield, (x0, x1), _ = toy
    jt, tt = _theta0(init, nfe)
    jloss, jgrad = jax.value_and_grad(
        lambda th: jbns._loss_fn(jbns.ns_sampler(jfield), th, jnp.asarray(x0),
                                 jnp.asarray(x1)))(jt)
    th = tns.BNSParams(*(p.clone().requires_grad_(True) for p in tt))
    loss = tbns._loss_fn(tbns.ns_sampler(tfield), th, *_tpairs((x0, x1)))
    grads = torch.autograd.grad(loss, list(th))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=TOL, atol=TOL)
    for g, w in zip(grads, jgrad):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def smoke():
    jcfg = jax_get_config("yi-6b", smoke=True)
    jparams = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    cfg = get_config("yi-6b", smoke=True)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    tok = np.random.default_rng(5).integers(0, cfg.vocab, size=(2, 8))
    return jcfg, jparams, cfg, params, tok


def _backbone_loss_and_gradient(jcfg, jparams, cfg, params, jbatch, batch, remat):
    """_loss_fn and its gradient at euler NFE 4 on a backbone's velocity,
    the reference's by jax.value_and_grad and the port's by autograd, on the
    same numpy pairs. Tolerance 4 TOL as the backbone's sampling parity
    (tests/test_torch_serve.py) holds it; 1e-4 relative on the gradient,
    which sums 4 back-propagated backbone calls."""
    rng = np.random.default_rng(8)
    x0, x1 = rng.standard_normal((2, 2, 8, cfg.latent_dim)).astype(np.float32)
    jt, tt = _theta0("euler", 4)

    def jsample(th, x):
        u = lambda t, xx: jmodel.velocity(jparams, jcfg, t, xx, jbatch, remat=remat)  # noqa: E731
        return jns.ns_sample(jns.materialize(th), u, x)

    jloss, jgrad = jax.value_and_grad(
        lambda th: jbns._loss_fn(jsample, th, jnp.asarray(x0), jnp.asarray(x1)))(jt)
    field = tmodel.velocity_field(params, cfg, tsched.fm_ot(), batch, remat=remat)
    th = tns.BNSParams(*(p.clone().requires_grad_(True) for p in tt))
    loss = tbns._loss_fn(tbns.ns_sampler(field), th, *_tpairs((x0, x1)))
    grads = torch.autograd.grad(loss, list(th))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=4 * TOL, atol=4 * TOL)
    for g, w in zip(grads, jgrad):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-4, atol=4 * TOL)


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_gradient_match_reference_on_the_yi6b_backbone(smoke, remat):
    """The same on yi-6b's smoke backbone (2 layers, f32) at euler NFE 4,
    with and without each layer recomputed in the backward: remat changes
    neither the loss nor the gradient."""
    jcfg, jparams, cfg, params, tok = smoke
    _backbone_loss_and_gradient(jcfg, jparams, cfg, params, {"tokens": jnp.asarray(tok)},
                                {"tokens": torch.from_numpy(tok)}, remat)


@pytest.mark.parametrize("arch", ["rwkv6-7b", "zamba2-2.7b", "whisper-medium"])
def test_loss_and_gradient_match_reference_on_the_other_trained_backbones(arch):
    """The same on the smoke configs of the families that distil on the card
    through the gla_scan backward and the flash backward at hd 80 and 64
    (their forms on the CPU: the plain chunked recurrence, the plain
    attention): rwkv6-7b, zamba2-2.7b and whisper-medium (the batch's
    frames drawn by the reference's SyntheticTokens, handed to both), each
    layer recomputed in the backward, as the launcher distils."""
    from repro.data.synthetic import DataConfig as JaxDataConfig
    from repro.data.synthetic import SyntheticTokens as JaxSyntheticTokens
    from repro_torch.models import mamba2, rwkv6, whisper

    jcfg, cfg = jax_get_config(arch, smoke=True), get_config(arch, smoke=True)
    jparams = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    family = {"rwkv6-7b": rwkv6, "zamba2-2.7b": mamba2, "whisper-medium": whisper}[arch]
    params = family.params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    jbatch = JaxSyntheticTokens(jcfg, JaxDataConfig(batch_size=2, seq_len=8, seed=5)).batch(1)
    batch = {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()}
    batch["tokens"] = batch["tokens"].long()
    _backbone_loss_and_gradient(jcfg, jparams, cfg, params, jbatch, batch, remat=True)


def test_remat_recomputes_each_layer_in_the_backward(smoke):
    """With remat, every layer's forward runs again during the backward (the
    count of attention calls doubles); the gradient is the same."""
    from repro_torch.models import transformer

    _, _, cfg, params, tok = smoke
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 8, cfg.latent_dim)).astype(np.float32)).requires_grad_(True)
    calls = []
    real = transformer.attention_forward

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    transformer.attention_forward = counted
    try:
        grads = {}
        for remat in (False, True):
            calls.clear()
            u = tmodel.velocity(params, cfg, torch.tensor(0.3), x,
                                {"tokens": torch.from_numpy(tok)}, remat=remat)
            grads[remat] = torch.autograd.grad(u.square().sum(), x)[0]
            assert len(calls) == (2 if remat else 1) * cfg.n_layers
    finally:
        transformer.attention_forward = real
    torch.testing.assert_close(grads[True], grads[False], rtol=1e-6, atol=1e-7)


def test_train_bns_matches_reference_for_20_iterations(toy):
    """20 Adam iterations from one theta0 on shared pairs, mini-batches of 64
    of 128 drawn by np.random.default_rng(seed).choice in both, validated
    every 5: the history (loss, val PSNR) and the best theta agree. rtol
    1e-4: each step's f32 gradient differs from the jitted reference's in
    its last bits, and Adam's early steps are ~lr sign(g), so those bits
    carry into theta."""
    jfield, tfield, train, val = toy
    cfg = dict(nfe=4, init_solver="midpoint", lr=5e-3, lr_schedule="poly",
               iterations=20, batch_size=64, val_every=5, seed=3)
    want = jbns.train_bns(jfield, _jpairs(train), _jpairs(val), jbns.BNSTrainConfig(**cfg))
    got = tbns.train_bns(tfield, _tpairs(train), _tpairs(val), tbns.BNSTrainConfig(**cfg))
    assert [h[0] for h in got.history] == [h[0] for h in want.history] == [5, 10, 15, 20]
    np.testing.assert_allclose(np.array(got.history)[:, 1:], np.array(want.history)[:, 1:],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.val_psnr, want.val_psnr, rtol=1e-4)
    for g, w in zip(got.params, want.params):
        assert not g.requires_grad
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-4, atol=1e-5)
    assert got.num_parameters == want.num_parameters == tns.count_parameters(4)


@pytest.mark.parametrize("schedule", ["poly", "cosine"])
def test_train_bns_trained_beats_its_init(toy, schedule):
    _, tfield, train, val = toy
    cfg = tbns.BNSTrainConfig(nfe=4, init_solver="euler", lr=5e-3, lr_schedule=schedule,
                              iterations=150, val_every=50, batch_size=64)
    res = tbns.train_bns(tfield, _tpairs(train), _tpairs(val), cfg)
    x0v, x1v = _tpairs(val)
    with torch.no_grad():
        init = float(torch.mean(tbns.psnr(
            tns.ns_sample(treg.build_ns("euler", 4, None), tfield.fn, x0v), x1v)))
    assert res.val_psnr > init + 1.0, (res.val_psnr, init)
    assert [h[0] for h in res.history] == [50, 100, 150]


def test_psnr_increases_with_nfe(toy):
    _, tfield, train, val = toy
    scores = []
    for nfe in (4, 8):
        cfg = tbns.BNSTrainConfig(nfe=nfe, init_solver="midpoint", iterations=150,
                                  val_every=50, batch_size=64)
        scores.append(tbns.train_bns(tfield, _tpairs(train), _tpairs(val), cfg).val_psnr)
    assert scores[1] > scores[0], scores


@pytest.mark.parametrize("name", ["euler", "midpoint", "rk4"])
def test_bns_init_matches_init_solver(toy, name):
    """Before training, theta0 must reproduce the initial solver exactly."""
    _, tfield, _, val = toy
    x0 = torch.from_numpy(val[0])
    ns0 = treg.build_ns(name, 8, None)
    with torch.no_grad():
        xh = tns.ns_sample(tns.materialize(tns.from_ns(ns0)), tfield.fn, x0)
        xh_ref = tns.ns_sample(ns0, tfield.fn, x0)
    assert float((xh - xh_ref).abs().max()) < 1e-4


@pytest.mark.parametrize("n", range(1, 11))
def test_count_parameters_matches_reference(n):
    assert tns.count_parameters(n) == jns.count_parameters(n) == n * (n + 5) // 2 + 1


@pytest.mark.parametrize("name,nfe", [("euler", 4), ("midpoint", 6), ("rk4", 8)])
def test_ns_trajectory_matches_reference(toy, name, nfe):
    jfield, tfield, _, val = toy
    x0 = val[0][:16]
    want = jns.ns_trajectory(jreg.build_ns(name, nfe, jfield), jfield.fn, jnp.asarray(x0))
    got = tns.ns_trajectory(treg.build_ns(name, nfe, None), tfield.fn, torch.from_numpy(x0))
    assert got.shape == (nfe + 1, 16, 2)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=TOL, atol=TOL)
    with torch.no_grad():
        last = tns.ns_sample(treg.build_ns(name, nfe, None), tfield.fn, torch.from_numpy(x0))
    np.testing.assert_allclose(_np(got[-1]), _np(last), rtol=TOL, atol=TOL)


def test_generate_pairs_integrates_draws_of_the_generator(toy):
    _, tfield, _, _ = toy
    x0, x1 = tbns.generate_pairs(tfield, torch.Generator().manual_seed(4), 10, (2,),
                                 batch_size=4)
    assert x0.shape == x1.shape == (10, 2) and not x1.requires_grad
    again = torch.randn((4, 2), generator=torch.Generator().manual_seed(4))
    torch.testing.assert_close(x0[:4], again)
    torch.testing.assert_close(x1[:4], rk45_solve(tfield.fn, again).x1)


def test_solver_to_ns_is_a_deprecated_shim(toy):
    _, tfield, _, _ = toy
    with pytest.warns(DeprecationWarning):
        got = tbns.solver_to_ns("midpoint", 4, tfield)
    for a, b in zip(got, treg.build_ns("midpoint", 4, None)):
        torch.testing.assert_close(a, b)


def test_solver_params_carry_from_the_reference():
    jt = jns.from_ns(jreg.build_ns("midpoint", 6, None))
    tt = tns.bns_params_from_numpy(*(np.asarray(x) for x in jt))
    assert isinstance(tt, tns.BNSParams) and all(p.dtype == torch.float32 for p in tt)
    ns = tns.ns_params_from_numpy(*(np.asarray(x) for x in jns.materialize(jt)))
    for a, b in zip(ns, jns.materialize(jt)):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=0, atol=0)
    for a, b in zip(tns.materialize(tt), ns):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6, atol=1e-7)


def test_serve_distills_then_serves_on_cpu(capsys):
    """--bns-iters 20 on the CPU: RK45 pairs, the initial solver's val PSNR,
    20 iterations, 'solver ready', then the requests with the distilled
    solver, all through the plain versions (no kernel launch)."""
    before = (nu_mod.COUNTER.launches, nu_mod.BWD_COUNTER.launches,
              fa_mod.COUNTER.launches, fa_mod.BWD_COUNTER.launches)
    served = serve.main(["--arch", "yi-6b", "--mode", "flow", "--nfe", "4", "--batch", "2",
                         "--seq", "8", "--bns-iters", "20", "--requests", "2",
                         "--device", "cpu"])
    assert before == (nu_mod.COUNTER.launches, nu_mod.BWD_COUNTER.launches,
                      fa_mod.COUNTER.launches, fa_mod.BWD_COUNTER.launches)
    d = served.distillation
    assert d.iterations == 20 and d.num_parameters == tns.count_parameters(4)
    assert d.val_psnr >= d.init_val_psnr and np.isfinite(d.val_psnr)
    assert [h[0] for h in d.history] == [20] and np.isfinite(d.history[0][1])
    for part in ("train", "val"):
        nfe, acc, rej = d.rk45[part]
        assert nfe == 7 * (acc + rej) and acc > 0
    assert len(served) == 2 and all(s.nfe == 4 and s.latents.shape == (2, 8, 64)
                                    for s in served)
    out = capsys.readouterr().out
    for text in ("RK45 pairs: train nfe", "initial euler solver: val PSNR",
                 "solver ready: 19 params, val PSNR", "serving the distilled BNS solver",
                 "request 1: sampled (2, 8)"):
        assert text in out, out


def test_serve_distillation_serves_the_distilled_solver(monkeypatch):
    """The requests sample with the distilled NSParams, not the initial one:
    the launcher builds its session through ``FlowSampler.from_artifact``
    (as the reference's does), and the session holds the distilled solver."""
    seen = []
    real = serve.FlowSampler.from_artifact

    def spy(artifact, **kw):
        seen.append(artifact)
        return real(artifact, **kw)

    monkeypatch.setattr(serve.FlowSampler, "from_artifact", spy)
    served = serve.main(["--arch", "yi-6b", "--nfe", "4", "--batch", "2", "--seq", "8",
                         "--bns-iters", "5", "--requests", "1", "--device", "cpu"])
    (artifact,) = seen
    assert artifact is served.artifact and artifact.kind == "bns"
    solver = served.sampler.solver
    for a, b in zip(solver, served.distillation.solver):
        torch.testing.assert_close(a, b)
    assert not torch.equal(solver.b, treg.build_ns("euler", 4, None).b)


def test_serve_without_distillation_is_unchanged(capsys):
    served = serve.main(["--arch", "yi-6b", "--nfe", "4", "--batch", "2", "--seq", "8",
                         "--bns-iters", "0", "--requests", "1", "--device", "cpu"])
    assert served.distillation is None and len(served) == 1
    out = capsys.readouterr().out
    assert "serving the initial euler solver at NFE 4 (no distillation)" in out
    assert "distilling" not in out


def test_rwkv6_distills_on_the_cpu(capsys):
    """The plain chunked recurrence is differentiable, so rwkv6-7b distils on
    the CPU (the card refuses until gla_scan has a backward)."""
    served = serve.main(["--arch", "rwkv6-7b", "--nfe", "2", "--batch", "2", "--seq", "8",
                         "--bns-iters", "2", "--requests", "1", "--device", "cpu"])
    assert served.distillation.iterations == 2 and np.isfinite(served.distillation.val_psnr)
    assert "solver ready: 8 params" in capsys.readouterr().out


def test_train_config_and_result_fields_match_reference():
    assert ([f.name for f in dataclasses.fields(tbns.BNSTrainConfig)]
            == [f.name for f in dataclasses.fields(jbns.BNSTrainConfig)])
    assert tbns.BNSTrainConfig() == tbns.BNSTrainConfig(**dataclasses.asdict(
        jbns.BNSTrainConfig()))
    assert ([f.name for f in dataclasses.fields(tbns.TrainResult)]
            == [f.name for f in dataclasses.fields(jbns.TrainResult)])
