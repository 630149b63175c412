"""Anytime solvers in the port (``repro_torch.core.anytime`` and
``AnytimeFlowSampler``) against ``repro.core.anytime``, on the CPU.

Mirrors ``tests/test_anytime.py`` and ``tests/test_anytime_serving.py`` and
adds the parity cases: the initial solver and the extracted solvers equal
the reference's; ``anytime_sample``, the loss and its gradient (against
``jax.value_and_grad``) and 20 iterations of ``train_anytime`` agree within
the stated tolerances; and, in the port, every exit equals its extracted
m-step solver to the bit, through any split of the trajectory into carry
legs (the exit-boundary join invariant). Parameters cross from the
reference as numpy; jittered ones are made with numpy from a seed. The toy
field is the two-moons mixture; the backbone yi-6b's smoke config in f32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import anytime as janytime
from repro.core import ns_solver as jns
from repro.core import schedulers as jsched
from repro.core import toy as jtoy
from repro.core.bns import BNSTrainConfig as JaxTrainConfig
from repro.core.rk45 import rk45_solve as jax_rk45
from repro_torch.core import anytime
from repro_torch.core import ns_solver as tns
from repro_torch.core import schedulers as tsched
from repro_torch.core import toy as ttoy
from repro_torch.core.bns import BNSTrainConfig, psnr
from repro_torch.kernels.ns_update import ns_update as nu_mod
from repro_torch.serving.engine import AnytimeFlowSampler, FlowSampler
from repro_torch.solvers import SolverArtifact, SolverSpec, build_ns, ns_at_budget

TOL = 2e-5
BUDGET_SETS = [(4,), (2, 4), (4, 8), (2, 4, 8), (4, 8, 16), (3, 6, 12)]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Thousands of tiny eager ops a test: one intra-op thread beside the
    other test workers (as the distillation test files do)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _random_anytime(budgets, seed, scale=0.1):
    """Nested-init params jittered everywhere (numpy, from ``seed``), so
    indexing faults cannot hide behind structural zeros: (port, reference)."""
    rng = np.random.default_rng(seed)
    leaves = [np.asarray(x) + np.float32(scale) * rng.standard_normal(np.shape(x)).astype(
        np.float32) for x in janytime.init_anytime(None, budgets, "nested")]
    return (anytime.anytime_params_from_numpy(*leaves),
            janytime.AnytimeParams(*(jnp.asarray(x) for x in leaves)))


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


def _t(p):
    return tuple(torch.tensor(a) for a in p)


def _j(p):
    return tuple(jnp.asarray(a) for a in p)


# ---------------------------------------------------------------------------
# The grid and the initial solver
# ---------------------------------------------------------------------------


def test_nested_grid_prefixes_spread():
    g = anytime.nested_grid([4, 8, 16])
    assert len(g) == 16 and len(set(g.tolist())) == 16
    for m in (4, 8, 16):
        assert g[:m].max() >= 1.0 - 1.0 / m - 1e-9
        assert g[:m].min() == 0.0


@pytest.mark.parametrize("budgets", BUDGET_SETS)
def test_nested_grid_is_permutation_and_equals_the_reference(budgets):
    g = anytime.nested_grid(budgets)
    assert len(g) == max(budgets)
    union = sorted({i / m for m in budgets for i in range(m)})
    assert sorted(g.tolist()) == pytest.approx(union)
    np.testing.assert_array_equal(g, janytime.nested_grid(budgets))


@pytest.mark.parametrize("budgets", BUDGET_SETS)
def test_nested_grid_each_prefix_covers_budget_grid(budgets):
    g = anytime.nested_grid(budgets)
    for m in budgets:
        assert set(g[:m].tolist()) == {i / m for i in range(m)}, m


@pytest.mark.parametrize("budgets,mode", [(b, "nested") for b in BUDGET_SETS]
                         + [((2, 4), "prefix"), ((4, 8), "prefix"), ((2, 4, 8), "prefix")])
def test_init_anytime_equals_the_reference(budgets, mode):
    """Every field f32 and equal; time_raw's logit within one f32 ulp (XLA's
    f32 log is 1 ulp off the correctly rounded value for some grid times,
    torch's is not: ROADMAP Queue C 2)."""
    got = anytime.init_anytime(None, budgets, mode)
    want = janytime.init_anytime(None, budgets, mode)
    assert type(got).__name__ == type(want).__name__ == "AnytimeParams"
    for name, a, b in zip(got._fields, got, want):
        assert a.dtype == torch.float32 and a.shape == np.shape(b), name
        if name == "time_raw":
            np.testing.assert_array_max_ulp(_np(a), np.asarray(b), maxulp=1)
        else:
            np.testing.assert_array_equal(_np(a), np.asarray(b), err_msg=name)


def test_prefix_init_matches_generic_solver(toy):
    """mode='prefix' untrained ~ the initializing generic solver at n=max."""
    _, tfield, _, val = toy
    x0 = torch.tensor(val[0])
    theta = anytime.init_anytime(tfield, [4, 8], "prefix", "midpoint")
    with torch.no_grad():
        outs = anytime.anytime_sample(theta, [4, 8], tfield.fn, x0)
        ref8 = tns.ns_sample(build_ns("midpoint", 8), tfield.fn, x0)
    # time clipping (t=0 -> 0.02) perturbs the first eval slightly
    np.testing.assert_allclose(_np(outs[8]), _np(ref8), atol=2e-2)
    assert bool(torch.isfinite(outs[4]).all())


# ---------------------------------------------------------------------------
# Early-exit extraction and the join invariant
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("budgets", [(2, 4), (4, 8), (2, 4, 8), (3, 6, 12)])
def test_extract_ns_equals_the_reference(budgets):
    theta, jtheta = _random_anytime(budgets, 0)
    for m in budgets:
        got, want = anytime.extract_ns(theta, budgets, m), janytime.extract_ns(jtheta, budgets, m)
        assert got.n == m
        for a, b in zip(got, want):
            np.testing.assert_array_equal(_np(a), np.asarray(b))


@pytest.mark.parametrize("budgets", [(2, 4), (4, 8), (2, 4, 8)])
def test_extracted_solver_bit_exact(toy, budgets):
    """Every early exit == the extracted m-step solver through ns_sample, to
    the bit (the same update calls on the same inputs)."""
    _, tfield, _, _ = toy
    theta, _ = _random_anytime(budgets, 0)
    x0 = torch.from_numpy(np.random.default_rng(1).standard_normal((32, 2)).astype(np.float32))
    with torch.no_grad():
        outs = anytime.anytime_sample(theta, budgets, tfield.fn, x0)
        for m in budgets:
            ns = anytime.extract_ns(theta, budgets, m)
            assert ns.n == m
            assert torch.equal(outs[m], tns.ns_sample(ns, tfield.fn, x0)), m


@pytest.mark.parametrize("budgets", [(2, 4, 8), (4, 8, 16), (3, 6, 12)])
def test_join_invariant_bit_exact_through_carry_legs(toy, budgets):
    """For every boundary k and served budget m > k: a prefix leg to k from
    the request's own noise, then the leg k -> m, gives exits[m] equal to the
    extracted m-step solver in one go, to the bit; the legs' carry equals
    the one-leg carry, and the input carry is left as it was."""
    _, tfield, _, _ = toy
    theta, _ = _random_anytime(budgets, 2)
    x0 = torch.from_numpy(np.random.default_rng(3).standard_normal((16, 2)).astype(np.float32))
    with torch.no_grad():
        direct = {m: tns.ns_sample(anytime.extract_ns(theta, budgets, m), tfield.fn, x0)
                  for m in budgets}
        fresh = anytime.anytime_carry(theta, budgets, x0)
        whole, _ = anytime.anytime_extend(theta, budgets, tfield.fn, fresh, max(budgets))
        for k in [0] + list(budgets[:-1]):
            carry, seen = fresh, {}
            if k:
                carry, seen = anytime.anytime_extend(theta, budgets, tfield.fn, fresh, k)
                assert carry.step == k and torch.equal(fresh.U, torch.zeros_like(fresh.U))
            before = carry.U.clone()
            for m in [b for b in budgets if b > k]:
                nxt, exits = anytime.anytime_extend(theta, budgets, tfield.fn, carry, m)
                assert torch.equal(carry.U, before)          # the input carry is kept
                seen.update(exits)
                carry, before = nxt, nxt.U.clone()
            for m, out in seen.items():
                assert torch.equal(out, direct[m]), (k, m)
            assert torch.equal(carry.x, whole.x) and torch.equal(carry.U, whole.U)


def test_extend_under_grad_matches_no_grad_and_keeps_the_carry(toy):
    """The differentiable path (velocities stacked, nothing written in place)
    gives the no-grad path's exits and carry, and a gradient flows to every
    field through a two-leg trajectory."""
    _, tfield, _, _ = toy
    budgets = (2, 4, 8)
    theta, _ = _random_anytime(budgets, 4)
    x0 = torch.from_numpy(np.random.default_rng(5).standard_normal((8, 2)).astype(np.float32))
    with torch.no_grad():
        want = anytime.anytime_sample(theta, budgets, tfield.fn, x0)
    th = anytime.AnytimeParams(*(p.clone().requires_grad_(True) for p in theta))
    c1, e1 = anytime.anytime_extend(th, budgets, tfield.fn,
                                    anytime.anytime_carry(th, budgets, x0), 4)
    c2, e2 = anytime.anytime_extend(th, budgets, tfield.fn, c1, 8)
    assert c1.U[4:].abs().sum() == 0 and c2.step == 8
    outs = {**e1, **e2}
    for m in budgets:
        torch.testing.assert_close(outs[m], want[m], rtol=1e-6, atol=1e-6)
    grads = torch.autograd.grad(sum(o.square().sum() for o in outs.values()), list(th))
    for name, g in zip(th._fields, grads):
        assert bool(torch.isfinite(g).all()) and float(g.abs().sum()) > 0, name


def test_extracted_solver_costs_exactly_m_nfe(toy):
    _, tfield, _, _ = toy
    budgets = (2, 4, 8)
    theta, _ = _random_anytime(budgets, 0)
    x0 = torch.zeros((8, 2))
    for m in budgets:
        calls = []

        def counting(t, x):
            calls.append(1)
            return tfield.fn(t, x)

        with torch.no_grad():
            tns.ns_sample(anytime.extract_ns(theta, budgets, m), counting, x0)
        assert len(calls) == m


def test_extract_ns_validates_budget():
    theta = anytime.init_anytime(None, (2, 4), "nested")
    with pytest.raises(ValueError):
        anytime.extract_ns(theta, (2, 4), 3)
    assert ns_at_budget(theta, (2, 4), 2).n == 2
    ns = anytime.extract_ns(theta, (2, 4), 4)
    assert ns_at_budget(ns, (4,), 4) is ns
    with pytest.raises(ValueError):
        ns_at_budget(ns, (4,), 2)
    with pytest.raises(ValueError):
        anytime.anytime_extend(theta, (2, 4), None,
                               anytime.anytime_carry(theta, (2, 4), torch.zeros(1, 2)), 5)


def test_extracted_top_budget_is_whole_solver(toy):
    _, tfield, _, _ = toy
    budgets = (4, 8)
    theta, _ = _random_anytime(budgets, 3)
    x0 = torch.from_numpy(np.random.default_rng(4).standard_normal((16, 2)).astype(np.float32))
    with torch.no_grad():
        got = tns.ns_sample(anytime.extract_ns(theta, budgets, 8), tfield.fn, x0)
        ref = anytime.anytime_sample(theta, budgets, tfield.fn, x0)[8]
    assert torch.equal(got, ref)


def test_exits_go_through_the_update_hook_with_live_rows_only(toy):
    """Each rule hands the hook U[:k] and its k live weights (ns_sample's
    contract): 8 intermediate rules and one exit for budgets (4, 8)."""
    _, tfield, _, _ = toy
    theta, _ = _random_anytime((4, 8), 6)
    seen = []

    def hook(x0, U, a, w):
        seen.append((U.shape[0], w.shape[0], a.dim()))
        return a * x0 + torch.tensordot(w, U, dims=1)

    with torch.no_grad():
        anytime.anytime_sample(theta, (4, 8), tfield.fn, torch.zeros((3, 2)), update_fn=hook)
    assert seen == [(1, 1, 0), (2, 2, 0), (3, 3, 0), (4, 4, 0), (4, 4, 0), (5, 5, 0),
                    (6, 6, 0), (7, 7, 0), (8, 8, 0)]


# ---------------------------------------------------------------------------
# Against the reference: samples, loss, gradient, training
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("budgets", [(2, 4), (4, 8), (2, 4, 8)])
def test_anytime_sample_matches_the_reference(toy, budgets):
    jfield, tfield, _, val = toy
    theta, jtheta = _random_anytime(budgets, 7)
    with torch.no_grad():
        got = anytime.anytime_sample(theta, budgets, tfield.fn, torch.tensor(val[0]))
    want = janytime.anytime_sample(jtheta, budgets, jfield.fn, jnp.asarray(val[0]))
    assert sorted(got) == sorted(want) == sorted(budgets)
    for m in budgets:
        np.testing.assert_allclose(_np(got[m]), np.asarray(want[m]), rtol=TOL * m,
                                   atol=TOL * m)


def _reference_loss(jtheta, budgets, u_fn, x0, x1):
    """The reference's train_anytime loss (a closure there), written out."""
    weights = {m: (2.0 if m == budgets[-1] else 1.0) for m in budgets}
    outs = janytime.anytime_sample(jtheta, budgets, u_fn, x0)
    total = 0.0
    for m in budgets:
        mse = jnp.mean((outs[m] - x1) ** 2, axis=tuple(range(1, x0.ndim)))
        total = total + weights[m] * jnp.mean(jnp.log(jnp.maximum(mse, 1e-20)))
    return total / sum(weights.values())


@pytest.mark.parametrize("budgets", [(2, 4), (4, 8), (2, 4, 8)])
def test_loss_and_gradient_match_the_reference(toy, budgets):
    """anytime_loss and its gradient in every field of AnytimeParams against
    jax.value_and_grad; rtol 1e-4 on the gradient, as
    tests/test_torch_bns.py holds the BNS gradient on this field."""
    jfield, tfield, train, _ = toy
    theta, jtheta = _random_anytime(budgets, 8)
    jloss, jgrad = jax.value_and_grad(_reference_loss)(jtheta, budgets, jfield.fn,
                                                       *_j(train))
    th = anytime.AnytimeParams(*(p.clone().requires_grad_(True) for p in theta))
    loss = anytime.anytime_loss(th, budgets, tfield.fn, *_t(train))
    grads = torch.autograd.grad(loss, list(th))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=TOL, atol=TOL)
    for name, g, w in zip(th._fields, grads, jgrad):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-4, atol=1e-5, err_msg=name)


@pytest.fixture(scope="module")
def smoke():
    from repro.configs import get_config as jax_get_config
    from repro.models import model as jmodel
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import params_from_jax

    jcfg = jax_get_config("yi-6b", smoke=True)
    jparams = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    cfg = get_config("yi-6b", smoke=True)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    tok = np.random.default_rng(5).integers(0, cfg.vocab, size=(2, 8))
    return jcfg, jparams, cfg, params, tok


def test_loss_and_gradient_match_the_reference_on_the_yi6b_backbone(smoke):
    """The same through yi-6b's smoke backbone (2 layers, f32), each layer
    recomputed in the backward, budgets (2, 4): 4 TOL on the loss as the
    backbone's sampling parity holds it, 1e-4 relative on the gradient."""
    from repro.models import model as jmodel
    from repro_torch.models import model as tmodel

    jcfg, jparams, cfg, params, tok = smoke
    budgets = (2, 4)
    theta, jtheta = _random_anytime(budgets, 9)
    x0, x1 = np.random.default_rng(10).standard_normal((2, 2, 8, cfg.latent_dim)).astype(
        np.float32)
    ju = jmodel.velocity_field(jparams, jcfg, jsched.fm_ot(), {"tokens": jnp.asarray(tok)}).fn
    jloss, jgrad = jax.value_and_grad(_reference_loss)(jtheta, budgets, ju, jnp.asarray(x0),
                                                       jnp.asarray(x1))
    field = tmodel.velocity_field(params, cfg, tsched.fm_ot(),
                                  {"tokens": torch.from_numpy(tok)}, remat=True)
    th = anytime.AnytimeParams(*(p.clone().requires_grad_(True) for p in theta))
    loss = anytime.anytime_loss(th, budgets, field.fn, torch.from_numpy(x0),
                                torch.from_numpy(x1))
    grads = torch.autograd.grad(loss, list(th))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=4 * TOL, atol=4 * TOL)
    for name, g, w in zip(th._fields, grads, jgrad):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-4, atol=4 * TOL,
                                   err_msg=name)


def test_train_anytime_matches_reference_for_20_iterations(toy):
    """20 Adam iterations from each package's init on shared pairs,
    mini-batches of 64 of 128 drawn by the same seeded numpy generator,
    validated every 5: history and best theta within rtol 1e-4 (the f32
    gradient's last bits carry into Adam's ~lr sign(g) early steps)."""
    jfield, tfield, train, val = toy
    cfg = dict(nfe=8, init_solver="midpoint", lr=5e-3, lr_schedule="poly", iterations=20,
               batch_size=64, val_every=5, seed=3)
    want = janytime.train_anytime(jfield, [4, 8], _j(train), _j(val), JaxTrainConfig(**cfg))
    got = anytime.train_anytime(tfield, [4, 8], _t(train), _t(val), BNSTrainConfig(**cfg))
    assert [h[0] for h in got.history] == [h[0] for h in want.history] == [5, 10, 15, 20]
    np.testing.assert_allclose(np.array(got.history)[:, 1:], np.array(want.history)[:, 1:],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.val_psnr, want.val_psnr, rtol=1e-4)
    for name, g, w in zip(got.params._fields, got.params, want.params):
        assert not g.requires_grad
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-4, atol=1e-5, err_msg=name)
    assert (got.nfe, got.num_parameters) == (want.nfe, want.num_parameters)


def test_anytime_nested_beats_prefix_at_small_budgets(toy):
    _, tfield, train, val = toy
    cfg = BNSTrainConfig(nfe=8, init_solver="midpoint", iterations=800, lr=1.5e-3,
                         val_every=200, batch_size=64)
    scores = {mode: anytime.evaluate_anytime(
        anytime.train_anytime(tfield, [4, 8], _t(train), _t(val), cfg, mode=mode).params,
        [4, 8], tfield, _t(val)) for mode in ("nested", "prefix")}
    assert scores["nested"][4] > scores["prefix"][4] + 3.0, scores


def test_anytime_all_budgets_beat_generic_baseline(toy):
    _, tfield, train, val = toy
    cfg = BNSTrainConfig(nfe=8, init_solver="midpoint", iterations=3000, lr=2e-3,
                         val_every=300, batch_size=64)
    res = anytime.train_anytime(tfield, [4, 8], _t(train), _t(val), cfg, mode="nested")
    scores = anytime.evaluate_anytime(res.params, [4, 8], tfield, _t(val))
    x0v, x1v = _t(val)
    for m in (4, 8):
        with torch.no_grad():
            base = float(torch.mean(psnr(tns.ns_sample(build_ns("midpoint", m), tfield.fn,
                                                       x0v), x1v)))
        assert scores[m] > base, (m, scores[m], base)


# ---------------------------------------------------------------------------
# AnytimeFlowSampler (smoke backbone)
# ---------------------------------------------------------------------------

BUDGETS = (2, 4)


@pytest.fixture(scope="module")
def served(smoke):
    _, _, cfg, params, _ = smoke
    theta, jtheta = _random_anytime(BUDGETS, 7)
    art = SolverArtifact(spec=SolverSpec("midpoint", mode="anytime", budgets=BUDGETS),
                         params=theta, val_psnr=0.0)
    return art, jtheta, AnytimeFlowSampler.from_artifact(art, params=params, cfg=cfg,
                                                         sched=tsched.fm_ot())


def _batch(tok):
    return {"tokens": torch.from_numpy(tok)}


def test_engine_budget_matches_evaluate_anytime(smoke, served):
    from repro_torch.models import model as tmodel

    _, _, cfg, params, tok = smoke
    art, _, sampler = served
    field = tmodel.velocity_field(params, cfg, tsched.fm_ot(), _batch(tok))
    rng = np.random.default_rng(8)
    x0, x1 = (torch.from_numpy(rng.standard_normal((2, 8, cfg.latent_dim)).astype(np.float32))
              for _ in "01")
    ref = anytime.evaluate_anytime(art.params, BUDGETS, field, (x0, x1))
    for m in BUDGETS:
        got = float(torch.mean(psnr(sampler.sample_from(_batch(tok), x0, m), x1)))
        assert got == pytest.approx(ref[m], abs=1e-3), m


def test_engine_sample_all_matches_per_budget_to_the_bit(smoke, served):
    _, _, cfg, _, tok = smoke
    _, _, sampler = served
    x0 = np.random.default_rng(10).standard_normal((2, 8, cfg.latent_dim)).astype(np.float32)
    outs = sampler.sample_all_from(_batch(tok), x0)
    assert sorted(outs) == sorted(BUDGETS)
    for m in BUDGETS:
        assert torch.equal(outs[m], sampler.sample_from(_batch(tok), x0, m))
    carry = sampler.carry_start(_batch(tok), x0)
    exits = {}
    for stop in BUDGETS:
        carry, e = sampler.carry_extend(_batch(tok), carry, stop)
        exits.update(e)
    for m in BUDGETS:
        assert torch.equal(exits[m], outs[m])
    g = torch.Generator().manual_seed(3)
    all_g = sampler.sample_all(_batch(tok), g)
    assert torch.equal(all_g[4], sampler.sample(_batch(tok), torch.Generator().manual_seed(3),
                                                budget=4))


def test_engine_matches_the_reference_sampler(smoke, served):
    """sample_from, sample_all_from and carry legs against the reference's
    AnytimeFlowSampler on the same x0 (f32 TOL scaled by NFE)."""
    from repro.serving import AnytimeFlowSampler as JaxAnytimeSampler
    from repro.solvers import SolverArtifact as JaxArtifact
    from repro.solvers import SolverSpec as JaxSpec

    jcfg, jparams, cfg, _, tok = smoke
    _, jtheta, sampler = served
    ref = JaxAnytimeSampler.from_artifact(
        JaxArtifact(spec=JaxSpec("midpoint", mode="anytime", budgets=BUDGETS), params=jtheta,
                    val_psnr=0.0), params=jparams, cfg=jcfg, sched=jsched.fm_ot())
    x0 = np.random.default_rng(11).standard_normal((2, 8, cfg.latent_dim)).astype(np.float32)
    jb = {"tokens": jnp.asarray(tok)}
    want_all = ref.sample_all_from(jb, jnp.asarray(x0))
    got_all = sampler.sample_all_from(_batch(tok), x0)
    jc, _ = ref.carry_extend(jb, ref.carry_start(jb, jnp.asarray(x0)), 2)
    tc, _ = sampler.carry_extend(_batch(tok), sampler.carry_start(_batch(tok), x0), 2)
    for m in BUDGETS:
        for got, want in ((got_all[m], want_all[m]),
                          (sampler.sample_from(_batch(tok), x0, m),
                           ref.sample_from(jb, jnp.asarray(x0), m))):
            np.testing.assert_allclose(_np(got), np.asarray(want), rtol=TOL * m, atol=TOL * m)
    np.testing.assert_allclose(_np(tc.U), np.asarray(jc.U), rtol=2 * TOL, atol=2 * TOL)
    np.testing.assert_allclose(_np(tc.x), np.asarray(jc.x), rtol=2 * TOL, atol=2 * TOL)


def test_engine_resolves_unserved_budgets(served):
    _, _, sampler = served
    assert sampler.resolve_budget(2) == 2
    assert sampler.resolve_budget(3) == 2       # tie breaks to the cheaper
    assert sampler.resolve_budget(16) == 4
    with pytest.raises(ValueError):
        sampler.resolve_budget(16, strict=True)
    with pytest.raises(ValueError):
        sampler.sample_from({}, None, 16)       # unserved budget, no routing
    assert sampler.ns_at_budget(2) is sampler.ns_at_budget(2)   # made once


def test_engine_rejects_wrong_artifact_kinds(smoke, served):
    from repro_torch.models import model as tmodel

    _, _, cfg, params, tok = smoke
    art, _, _ = served
    with pytest.raises(TypeError):
        FlowSampler.from_artifact(art, params=params, cfg=cfg, sched=tsched.fm_ot())
    field = tmodel.velocity_field(params, cfg, tsched.fm_ot(), _batch(tok))
    single = SolverSpec("euler", 4).distill(
        field, None, (torch.zeros((2, 8, cfg.latent_dim)),
                      torch.ones((2, 8, cfg.latent_dim)))).artifact()
    with pytest.raises(TypeError):
        AnytimeFlowSampler.from_artifact(single, params=params, cfg=cfg, sched=tsched.fm_ot())


def test_engine_fixed_budget_session_matches_anytime_sampler(smoke, served):
    """FlowSampler.from_artifact(budget=m) == AnytimeFlowSampler at m."""
    _, _, cfg, params, tok = smoke
    art, _, sampler = served
    fixed = FlowSampler.from_artifact(art, params=params, cfg=cfg, sched=tsched.fm_ot(),
                                      budget=2)
    a = fixed.sample(_batch(tok), torch.Generator().manual_seed(12))
    b = sampler.sample(_batch(tok), torch.Generator().manual_seed(12), budget=2)
    assert torch.equal(a, b)


def test_engine_runs_the_plain_update_on_the_cpu(smoke, served):
    _, _, cfg, _, tok = smoke
    _, _, sampler = served
    before = nu_mod.COUNTER.launches
    sampler.sample_all_from(_batch(tok), np.zeros((2, 8, cfg.latent_dim), np.float32))
    assert nu_mod.COUNTER.launches == before


@pytest.mark.integration
def test_distilled_anytime_artifact_serves_every_budget(toy, tmp_path):
    """distill -> artifact -> save/load -> serve each budget m at exactly m
    NFE with PSNR equal to evaluate_anytime on the same pairs."""
    _, tfield, train, val = toy
    budgets = (2, 4)
    spec = SolverSpec("midpoint", mode="anytime", budgets=budgets)
    res = spec.distill(tfield, _t(train), _t(val),
                       BNSTrainConfig(iterations=60, val_every=20, batch_size=32))
    path = str(tmp_path / "anytime.msgpack")
    res.artifact().save(path)
    art = SolverArtifact.load(path)
    assert art.spec == spec and art.budgets == budgets
    for a, b in zip(res.params, art.params):
        assert torch.equal(a, b)
    ref = anytime.evaluate_anytime(art.params, budgets, tfield, _t(val))
    for m in budgets:
        calls = []

        def counting(t, x):
            calls.append(1)
            return tfield.fn(t, x)

        with torch.no_grad():
            out = tns.ns_sample(art.ns_at_budget(m), counting, _t(val)[0])
        assert len(calls) == m
        assert float(torch.mean(psnr(out, _t(val)[1]))) == pytest.approx(ref[m], abs=1e-3)
