"""Bespoke Scale-Time solvers in the port (``repro_torch.core.bst_solver``,
``bns.bst_sampler`` / ``train_bst``, BST specs and artifacts, and the
paper-claims twin ``repro_torch.benchmarks.psnr_vs_nfe``) against the
reference, on the CPU.

Inputs are numpy from a seed; (x0, x1) pairs are x0 from a seed and the
reference's RK45 solve of it, handed to both packages as numpy. The toy
field is the two-moons Gaussian mixture of ``tests/test_bns.py``.
Tolerances are f32 2e-5 unless a case says why.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bns as jbns
from repro.core import bst_solver as jbst
from repro.core import schedulers as jsched
from repro.core import st_transform as jst
from repro.core import taxonomy as jtax
from repro.core import toy as jtoy
from repro.core.rk45 import rk45_solve as jax_rk45
from repro.solvers import SolverArtifact as JaxArtifact
from repro.solvers import SolverSpec as JaxSpec
from repro.solvers.spec import reduce_to_ns as jreduce
from repro_torch.core import bns as tbns
from repro_torch.core import bst_solver as tbst
from repro_torch.core import ns_solver as tns
from repro_torch.core import schedulers as tsched
from repro_torch.core import st_transform as tst
from repro_torch.core import taxonomy as ttax
from repro_torch.core import toy as ttoy
from repro_torch.kernels.ns_update import ns_update as nu_mod
from repro_torch.solvers import SolverArtifact, SolverSpec, reduce_to_ns

TOL = 2e-5
CASES = [("euler", 4), ("euler", 8), ("midpoint", 4), ("midpoint", 8)]


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


def _jp(p):
    return tuple(jnp.asarray(a) for a in p)


def _tp(p):
    return tuple(torch.from_numpy(a) for a in p)


def _random_params(nfe, base, seed):
    """Knot parameters near the identity, numpy f32 from a seed."""
    k = int(jbst.knot_positions(nfe, base).shape[0])
    rng = np.random.default_rng(seed)
    return [(0.3 * rng.standard_normal(n)).astype(np.float32) for n in (k - 1, k, k, k)]


def _both(arrays):
    return (jbst.BSTParams(*(jnp.asarray(a) for a in arrays)),
            tbst.bst_params_from_numpy(*arrays))


def _close(got, want, tol=TOL):
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=tol, atol=tol)


@pytest.mark.parametrize("base,nfe", CASES)
def test_knot_positions_and_identity_bst_match_the_reference(base, nfe):
    np.testing.assert_array_equal(tbst.knot_positions(nfe, base).numpy(),
                                  np.asarray(jbst.knot_positions(nfe, base)))
    got, want = tbst.identity_bst(nfe, base), jbst.identity_bst(nfe, base)
    assert [tuple(x.shape) for x in got] == [x.shape for x in want]
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    _close(tbst.materialize_bst(got), jbst.materialize_bst(want))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("base,nfe", [("euler", 8), ("midpoint", 8)])
def test_materialize_bst_matches_the_reference(base, nfe, seed):
    jp, tp = _both(_random_params(nfe, base, seed))
    got, want = tbst.materialize_bst(tp), jbst.materialize_bst(jp)
    _close(got, want)
    assert float(got.t[0]) == 0.0 and abs(float(got.t[-1]) - 1.0) < 1e-6


@pytest.mark.parametrize("sname", ["fm_ot", "fm_cs", "vp"])
@pytest.mark.parametrize("base,nfe", [("euler", 4), ("midpoint", 8)])
@pytest.mark.parametrize("sigma0", [2.0, 0.5])
def test_from_st_transform_matches_the_reference(sname, base, nfe, sigma0):
    """Knots from the eq. 14 preconditioning transform: each knot evaluated
    alone where the reference vmaps over r."""
    def st(mod, sched):
        return mod.scheduler_change_st(sched, mod.scaled_sigma(sched, sigma0))

    got = tbst.from_st_transform(st(tst, tsched.get_scheduler(sname)), nfe, base)
    want = jbst.from_st_transform(st(jst, jsched.get_scheduler(sname)), nfe, base)
    _close(got, want, 5 * TOL)


@pytest.mark.parametrize("base,nfe", CASES)
def test_bst_program_direct_equals_its_ns_and_the_reference(toy, base, nfe):
    """Theorem 3.2's ST ⊂ NS inclusion on random knots in the port: the BST
    program run directly equals Algorithm 1 on its ``to_ns`` parameters;
    and both equal the reference's direct run."""
    jfield, tfield, _, val = toy
    jp, tp = _both(_random_params(nfe, base, nfe))
    prog = tbst.bst_euler_program if base == "euler" else tbst.bst_midpoint_program
    jprog = jbst.bst_euler_program if base == "euler" else jbst.bst_midpoint_program
    x0 = torch.from_numpy(val[0][:32])
    knots = tbst.materialize_bst(tp)
    with torch.no_grad():
        direct = ttax.run_direct(prog, tfield, x0, knots)
        via_ns = tns.ns_sample(ttax.to_ns(prog, knots), tfield.fn, x0)
    np.testing.assert_allclose(via_ns.numpy(), direct.numpy(), rtol=1e-5, atol=1e-5)
    want = jtax.run_direct(jprog, jfield, jnp.asarray(val[0][:32]),
                           jbst.materialize_bst(jp))
    np.testing.assert_allclose(direct.numpy(), np.asarray(want), rtol=TOL, atol=TOL * nfe)
    _close(ttax.to_ns(prog, knots), jtax.to_ns(jprog, jbst.materialize_bst(jp)), 5 * TOL)


@pytest.mark.parametrize("base", ["euler", "midpoint"])
def test_bst_loss_and_gradient_match_jax(toy, base):
    """bst_sampler under torch.autograd.grad: the PSNR loss and its gradient
    in every knot parameter against jax.value_and_grad, to 1e-4: f32
    reverse mode through every step's mixture softmax, summed in another
    order by XLA. ns_update does not launch: run_direct bypasses it."""
    jfield, tfield, train, _ = toy
    jp, tp = _both(_random_params(4, base, 11))
    x0, x1 = train[0][:64], train[1][:64]
    jl, jg = jax.value_and_grad(lambda th: jbns._loss_fn(
        jbns.bst_sampler(jfield, base), th, jnp.asarray(x0), jnp.asarray(x1)))(jp)
    th = tbst.BSTParams(*(p.clone().requires_grad_(True) for p in tp))
    before = nu_mod.COUNTER.launches
    loss = tbns._loss_fn(tbns.bst_sampler(tfield, base), th, torch.from_numpy(x0),
                         torch.from_numpy(x1))
    grads = torch.autograd.grad(loss, list(th))
    assert nu_mod.COUNTER.launches == before
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    _close(grads, jg, 1e-4)


@pytest.mark.parametrize("base", ["euler", "midpoint"])
def test_train_bst_matches_reference_for_20_iterations(toy, base):
    """20 Adam iterations from the identity knots on shared pairs, mini-batches
    of 64 of 128 drawn by np.random.default_rng(seed).choice in both,
    validated every 5: the history and the best theta agree. rtol 1e-4, as
    train_bns' test: each step's f32 gradient differs from the jitted
    reference's in its last bits, and Adam's early steps are ~lr sign(g)."""
    jfield, tfield, train, val = toy
    cfg = dict(nfe=4, lr=5e-3, lr_schedule="poly", iterations=20, batch_size=64,
               val_every=5, seed=3)
    want = jbns.train_bst(jfield, _jp(train), _jp(val), jbns.BNSTrainConfig(**cfg), base=base)
    got = tbns.train_bst(tfield, _tp(train), _tp(val), tbns.BNSTrainConfig(**cfg), base=base)
    assert [h[0] for h in got.history] == [h[0] for h in want.history] == [5, 10, 15, 20]
    np.testing.assert_allclose(np.array(got.history)[:, 1:], np.array(want.history)[:, 1:],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.val_psnr, want.val_psnr, rtol=1e-4)
    assert type(got.params).__name__ == "BSTParams"
    for g, w in zip(got.params, want.params):
        assert not g.requires_grad
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-4, atol=1e-5)
    assert got.num_parameters == want.num_parameters


def test_train_bst_with_sigma0_matches_reference(toy):
    """cfg.sigma0 != 1 starts from the preconditioning transform's knots."""
    jfield, tfield, train, val = toy
    cfg = dict(nfe=4, sigma0=2.0, lr=5e-3, iterations=5, batch_size=128, val_every=5)
    want = jbns.train_bst(jfield, _jp(train), _jp(val), jbns.BNSTrainConfig(**cfg))
    got = tbns.train_bst(tfield, _tp(train), _tp(val), tbns.BNSTrainConfig(**cfg))
    np.testing.assert_allclose(np.array(got.history)[:, 1:], np.array(want.history)[:, 1:],
                               rtol=1e-4, atol=1e-4)
    _close(got.params, want.params, 1e-4)


def test_train_bns_with_sigma0_matches_reference(toy):
    """BNS from a sigma0-preconditioned midpoint (eq. 14), once refused here."""
    jfield, tfield, train, val = toy
    cfg = dict(nfe=4, init_solver="midpoint", sigma0=2.0, lr=5e-3, iterations=5,
               batch_size=128, val_every=5)
    want = jbns.train_bns(jfield, _jp(train), _jp(val), jbns.BNSTrainConfig(**cfg))
    got = tbns.train_bns(tfield, _tp(train), _tp(val), tbns.BNSTrainConfig(**cfg))
    np.testing.assert_allclose(np.array(got.history)[:, 1:], np.array(want.history)[:, 1:],
                               rtol=1e-4, atol=1e-4)
    _close(got.params, want.params, 1e-4)


def test_trained_bst_holds_the_papers_bst_claim(toy):
    """benchmarks/psnr_vs_nfe.py's BST claim: trained BST >= Euler - 0.2 dB."""
    _, tfield, train, val = toy
    res = SolverSpec("euler", 4, mode="bst").distill(
        tfield, _tp(train), _tp(val),
        tbns.BNSTrainConfig(lr=1e-3, iterations=100, val_every=50, batch_size=64))
    euler = SolverSpec("euler", 4).sampler(tfield).psnr(_tp(val))
    assert res.val_psnr >= euler - 0.2, (res.val_psnr, euler)


def test_bst_spec_artifact_crosses_both_ways_byte_identical(toy, tmp_path):
    """A distilled BST solver: its artifact loads in the reference with
    bit-equal knots, the reference writes the same bytes for the same
    solver and meta, the port reloads it bit-equal, and ns_params raises
    the reference's TypeError."""
    _, tfield, train, val = toy
    res = SolverSpec("midpoint", 4, mode="bst").distill(
        tfield, _tp(train), _tp(val),
        tbns.BNSTrainConfig(iterations=10, val_every=5, batch_size=64))
    art = res.artifact(provenance={"base": "midpoint"})
    art.save(str(tmp_path / "port.msgpack"))
    ref = JaxArtifact.load(str(tmp_path / "port.msgpack"))
    assert ref.kind == "bst" and ref.spec == JaxSpec("midpoint", 4, mode="bst")
    for a, b in zip(art.params, ref.params):
        assert a.numpy().tobytes() == np.asarray(b).tobytes()
    ref.save(str(tmp_path / "ref.msgpack"))
    assert (tmp_path / "ref.msgpack").read_bytes() == (tmp_path / "port.msgpack").read_bytes()
    back = SolverArtifact.load(str(tmp_path / "ref.msgpack"))
    for a, b in zip(back.params, art.params):
        assert torch.equal(a, b)
    with pytest.raises(TypeError) as got:
        back.ns_params
    with pytest.raises(TypeError) as want:
        jreduce(ref.params)
    assert str(got.value) == str(want.value)
    with pytest.raises(TypeError):
        reduce_to_ns(res.params)


def _reference_rows(sname, iterations):
    """The reference's ``run`` cut to one scheduler at NFE 4, and its
    threefry pairs as numpy."""
    import benchmarks.psnr_vs_nfe as ref

    saved = ref.SCHEDS, ref.NFES
    ref.SCHEDS, ref.NFES = [sname], [4]
    try:
        field = ref.make_field(sname)
        pairs = [tuple(np.asarray(a) for a in jbns.generate_pairs(
            field, jax.random.PRNGKey(k), 256, (2,))) for k in (0, 1)]
        rows = ref.run(iterations=iterations, log=lambda s: None)
    finally:
        ref.SCHEDS, ref.NFES = saved
    return pairs, rows


def _twin_against_reference(sname, iterations, trained_tol, monkeypatch):
    import benchmarks.psnr_vs_nfe as ref
    from repro_torch.benchmarks import psnr_vs_nfe as twin

    pairs, want = _reference_rows(sname, iterations)
    monkeypatch.setattr(twin, "SCHEDS", [sname])
    monkeypatch.setattr(twin, "NFES", [4])
    assert twin.BASELINES == ref.BASELINES
    got = twin.run(iterations=iterations, pairs={sname: pairs}, device="cpu",
                   log=lambda s: None)
    assert len(got) == len(want) == 1
    for key in twin.BASELINES:
        assert abs(got[0][key] - want[0][key]) < 1e-3, (key, got[0][key], want[0][key])
    for key in ("bns", "bst"):
        assert abs(got[0][key] - want[0][key]) < trained_tol, (key, got[0][key],
                                                                want[0][key])
    monkeypatch.setattr(ref, "SCHEDS", [sname])
    verdicts = [[n.split("]")[0] for n in mod.check_paper_claims(rows)]
                for mod, rows in ((twin, got), (ref, want))]
    assert verdicts[0] == verdicts[1]


@pytest.mark.parametrize("sname", ["fm_ot", "vp"])
def test_paper_claims_twin_matches_the_reference_rows(sname, monkeypatch):
    """The port's psnr_vs_nfe on the reference's pairs, NFE 4, 100
    iterations: each baseline's PSNR within 1e-3 dB, the trained BNS and
    BST within 0.05 dB, and the same [PASS]/[FAIL] verdict on every claim."""
    _twin_against_reference(sname, 100, 0.05, monkeypatch)


def test_paper_claims_twin_at_full_iterations_on_the_reference_pairs(monkeypatch):
    """fm_ot at NFE 4 with the reference's 3000 iterations, on its pairs:
    the port's run fails the NFE-4 parity claim on its own torch-drawn pairs
    and passes it on these, as the reference does. Baselines within 1e-3
    dB; BNS and BST within 1 dB, since 3000 f32 Adam steps in two
    frameworks drift apart (0.69 and 0.08 dB here)."""
    _twin_against_reference("fm_ot", 3000, 1.0, monkeypatch)
