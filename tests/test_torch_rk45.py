"""The port's adaptive RK45 against ``repro.core.rk45``, on the CPU.

The reference's three checks (``tests/test_rk45.py``) on the port, and the
port's x1, nfe, accepted and rejected against the reference's on the same
numpy inputs, on the linear and mixture toy fields. Both carry the step's
time and size in f32 and take the same accept decisions, so the counts must
be equal down to rtol = atol = 1e-6 (at 1e-8 the estimate is f32 rounding
noise: see that case); x1 agrees to ``tests/test_kernels.py``'s f32 2e-5 where the
integration is well conditioned (the linear field) and 1e-4 on the mixture
field, whose flow amplifies roundoff near basin boundaries (the reference's
own test says so).

The step body as a program (``RK45Program``): through the CPU stand-in for
CUDA graphs (``torch_graph_double.CPUGraph``) the solve's x1 and counts
equal the eager solve's (``programs.disabled()``) to the bit, on the mixture
field and the 2-layer smoke backbone, and two same-shaped solves through one
program capture once.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import rk45 as jrk
from repro.core import schedulers as jsched
from repro.core import toy as jtoy
from repro_torch.configs import get_config
from repro_torch.core import bns as tbns
from repro_torch.core import rk45 as trk
from repro_torch.core import schedulers as tsched
from repro_torch.core import toy as ttoy
from repro_torch.launch import serve
from repro_torch.models import model as M
from repro_torch.serving import programs
from torch_graph_double import CPUGraph


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These tests run thousands of tiny eager ops (RK45 steps, training
    iterations); beside other test workers, torch's intra-op threads only
    contend for the cores, so each test runs on one and restores the count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mixtures():
    j = jtoy.mixture_field(jsched.fm_ot(), jtoy.two_moons_means(),
                           jnp.full((16,), 0.15), jnp.ones((16,)))
    t = ttoy.mixture_field(tsched.fm_ot(), ttoy.two_moons_means(),
                           torch.full((16,), 0.15), torch.ones((16,)))
    return j, t


def _x0(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_exact_on_linear_field():
    field = ttoy.linear_field(tsched.fm_ot())
    x0 = torch.from_numpy(_x0(0, (5, 3)))
    res = trk.rk45_solve(field.fn, x0, rtol=1e-8, atol=1e-8)
    exact = ttoy.linear_field_solution(x0, 1.0)
    # fp32 end-to-end: tolerance reflects accumulation roundoff, not method error
    np.testing.assert_allclose(res.x1.numpy(), exact.numpy(), atol=5e-4)
    assert res.accepted > 0


def test_tolerance_controls_error():
    _, field = _mixtures()
    x0 = torch.from_numpy(_x0(0, (8, 2)))
    fine = trk.rk45_solve(field.fn, x0, rtol=1e-8, atol=1e-8).x1
    coarse = trk.rk45_solve(field.fn, x0, rtol=1e-3, atol=1e-3)
    # multimodal flows amplify integration error near basin boundaries;
    # the bound reflects ODE conditioning, not solver accuracy.
    assert float((coarse.x1 - fine).abs().max()) < 0.15
    assert coarse.nfe < 10_000


def test_nfe_counts_evals():
    field = ttoy.linear_field(tsched.fm_ot())
    calls = []

    def counted(t, x):
        calls.append(float(t))
        return field.fn(t, x)

    res = trk.rk45_solve(counted, torch.ones((2, 2)), rtol=1e-5, atol=1e-5)
    assert isinstance(res.nfe, int) and isinstance(res.accepted, int)
    assert res.nfe == 7 * (res.accepted + res.rejected) == len(calls)


@pytest.mark.parametrize("tol", [1e-3, 1e-5, 1e-6])
@pytest.mark.parametrize("shape", [(5, 3), (2, 4, 6)])
def test_linear_field_matches_reference(tol, shape):
    jf = jtoy.linear_field(jsched.fm_ot())
    tf = ttoy.linear_field(tsched.fm_ot())
    x0 = _x0(len(shape) + int(-np.log10(tol)), shape)
    want = jrk.rk45_solve(jf.fn, jnp.asarray(x0), rtol=tol, atol=tol)
    got = trk.rk45_solve(tf.fn, torch.from_numpy(x0), rtol=tol, atol=tol)
    assert (got.nfe, got.accepted, got.rejected) == (
        int(want.nfe), int(want.accepted), int(want.rejected))
    np.testing.assert_allclose(got.x1.numpy(), np.asarray(want.x1), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("shape", [(5, 3), (2, 4, 6)])
def test_below_f32_resolution_counts_agree_to_two_percent(shape):
    """At rtol = atol = 1e-8 the error estimate of an f32 state is rounding
    noise (the state's own ulp is ~6e-8 |x|), and the two frameworks round
    their sums differently, so single accept decisions differ: the counts
    agree to 2% (the last bit of each decision is noise), and both land on
    the exact solution as the reference's own test asks (5e-4)."""
    jf = jtoy.linear_field(jsched.fm_ot())
    tf = ttoy.linear_field(tsched.fm_ot())
    x0 = _x0(len(shape) + 8, shape)
    want = jrk.rk45_solve(jf.fn, jnp.asarray(x0), rtol=1e-8, atol=1e-8)
    got = trk.rk45_solve(tf.fn, torch.from_numpy(x0), rtol=1e-8, atol=1e-8)
    for a, b in ((got.nfe, int(want.nfe)), (got.accepted, int(want.accepted))):
        assert abs(a - b) <= 0.02 * b
    exact = ttoy.linear_field_solution(torch.from_numpy(x0), 1.0).numpy()
    np.testing.assert_allclose(got.x1.numpy(), exact, atol=5e-4)
    np.testing.assert_allclose(np.asarray(want.x1), exact, atol=5e-4)


@pytest.mark.parametrize("tol,h0", [(1e-3, 0.01), (1e-5, 0.01), (1e-5, 0.3)])
def test_mixture_field_matches_reference(tol, h0):
    jf, tf = _mixtures()
    x0 = _x0(7, (16, 2))
    want = jrk.rk45_solve(jf.fn, jnp.asarray(x0), rtol=tol, atol=tol, h0=h0)
    got = trk.rk45_solve(tf.fn, torch.from_numpy(x0), rtol=tol, atol=tol, h0=h0)
    assert (got.nfe, got.accepted, got.rejected) == (
        int(want.nfe), int(want.accepted), int(want.rejected))
    np.testing.assert_allclose(got.x1.numpy(), np.asarray(want.x1), rtol=1e-4, atol=1e-4)


def test_max_steps_stops_the_loop():
    _, tf = _mixtures()
    res = trk.rk45_solve(tf.fn, torch.from_numpy(_x0(1, (4, 2))), rtol=1e-9, atol=1e-9,
                         max_steps=3)
    assert res.nfe == 21 and res.accepted + res.rejected == 3


@pytest.fixture
def graphs(monkeypatch):
    """Solves inside the test capture and replay through ``CPUGraph``."""
    monkeypatch.setattr(programs, "_graph_double", CPUGraph)


def _solves(fn, x0s, tol):
    """Each x0 solved in turn through one program; (results, its stats)."""
    program = trk.RK45Program(fn, "cpu")
    res = [trk.rk45_solve(fn, x0, rtol=tol, atol=tol, program=program) for x0 in x0s]
    return res, program.stats()


def _graphed_equals_eager(fn, x0s, tol):
    graphed, stats = _solves(fn, x0s, tol)
    with programs.disabled():
        eager, eager_stats = _solves(fn, x0s, tol)
    for g, e in zip(graphed, eager):
        assert (g.nfe, g.accepted, g.rejected) == (e.nfe, e.accepted, e.rejected)
        assert torch.equal(g.x1, e.x1)
    steps = sum(r.nfe // 7 for r in graphed)
    assert stats["programs"] == 1 and stats["replays"] == steps - 1
    assert eager_stats["programs"] == 0
    return graphed


@pytest.mark.parametrize("tol,h0", [(1e-3, 0.01), (1e-5, 0.3)])
def test_graphed_solve_equals_eager_on_the_mixture_field(graphs, tol, h0):
    """Two solves of one shape through one program: one capture, every
    later step a replay, x1 and the counts equal to the eager solve's."""
    _, tf = _mixtures()
    x0s = [torch.from_numpy(_x0(s, (16, 2))) for s in (3, 4)]
    _graphed_equals_eager(tf.fn, x0s, tol)


def test_graphed_solve_equals_eager_on_the_smoke_backbone(graphs):
    cfg = get_config("yi-6b", smoke=True)
    params = M.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    tok = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab, (2, 6)))
    field = M.velocity_field(params, cfg, tsched.fm_ot(), {"tokens": tok})
    x0s = [torch.from_numpy(_x0(s, (2, 6, cfg.latent_dim))) for s in (5, 6)]
    _graphed_equals_eager(field.fn, x0s, 1e-4)


def test_graphed_solve_matches_the_reference(graphs):
    """The graphed path keeps the reference's counts and x1 (the linear field)."""
    jf = jtoy.linear_field(jsched.fm_ot())
    tf = ttoy.linear_field(tsched.fm_ot())
    x0 = _x0(11, (5, 3))
    want = jrk.rk45_solve(jf.fn, jnp.asarray(x0), rtol=1e-5, atol=1e-5)
    got = trk.rk45_solve(tf.fn, torch.from_numpy(x0), rtol=1e-5, atol=1e-5)
    assert (got.nfe, got.accepted, got.rejected) == (
        int(want.nfe), int(want.accepted), int(want.rejected))
    np.testing.assert_allclose(got.x1.numpy(), np.asarray(want.x1), rtol=2e-5, atol=2e-5)


def test_a_program_refuses_another_field():
    _, tf = _mixtures()
    program = trk.RK45Program(tf.fn, "cpu")
    with pytest.raises(ValueError, match="another field"):
        trk.rk45_solve(ttoy.linear_field(tsched.fm_ot()).fn, torch.ones((2, 2)),
                       program=program)


def test_generate_pairs_chunks_share_one_program(graphs, monkeypatch):
    """Same-shaped chunks of ``generate_pairs`` go through one program: one
    capture in all; the pairs equal the eager ones to the bit."""
    _, tf = _mixtures()
    made = []
    inner = trk.RK45Program

    def spy(*a, **k):
        made.append(inner(*a, **k))
        return made[-1]

    monkeypatch.setattr(tbns, "RK45Program", spy)
    x0, x1 = tbns.generate_pairs(tf, torch.Generator().manual_seed(0), 8, (2,),
                                 batch_size=4, rtol=1e-4, atol=1e-4)
    with programs.disabled():
        ex0, ex1 = tbns.generate_pairs(tf, torch.Generator().manual_seed(0), 8, (2,),
                                       batch_size=4, rtol=1e-4, atol=1e-4)
    assert torch.equal(x0, ex0) and torch.equal(x1, ex1)
    assert made[0].stats()["programs"] == 1 and made[0].stats()["replays"] > 0
    assert made[1].stats()["programs"] == 0


def test_the_launchers_train_and_val_solves_share_one_program(graphs, capsys):
    served = serve.main(["--arch", "yi-6b", "--mode", "flow", "--nfe", "2", "--batch", "2",
                         "--seq", "4", "--bns-iters", "2", "--requests", "1",
                         "--device", "cpu"])
    d = served.distillation
    steps = sum(d.rk45[part][0] // 7 for part in ("train", "val"))
    assert d.rk45_programs["programs"] == 1 and d.rk45_programs["replays"] == steps - 1
    assert "step programs captured 1, replays" in capsys.readouterr().out
