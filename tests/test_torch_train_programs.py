"""Algorithm 2's programs (``repro_torch.core.bns.TrainLoop``, behind
``bns.fit``) on the CPU.

The card captures one CUDA graph for a training step and one for the
validation; here ``CPUGraph`` (``torch_graph_double.py``) stands in for them
through ``programs._graph_double``. ``train_bns``, ``train_bst`` and
``train_anytime`` through the double equal the same runs eager to the bit
(params, history, best iterate), on the toy field and on yi-6b's smoke
backbone with each layer recomputed in the backward; graphed ``train_bns``
and ``train_anytime`` equal the reference's 20 iterations at the tolerances
of ``test_torch_bns.py`` and ``test_torch_anytime.py``. What a graph needs
of the loop is checked one property at a time: one program a kind, the
learning rate gathered at Adam's device step, fixed addresses, the mini-batch
table drawn up front as the reference draws it, ``programs.disabled()``,
and no eager fallback when a capture fails.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import anytime as janytime
from repro.core import bns as jbns
from repro.core import schedulers as jsched
from repro.core import toy as jtoy
from repro.core.rk45 import rk45_solve as jax_rk45
from repro.models import model as jmodel
from repro_torch.configs import get_config
from repro_torch.core import anytime as tanytime
from repro_torch.core import bns as tbns
from repro_torch.core import bst_solver
from repro_torch.core import ns_solver as tns
from repro_torch.core import schedulers as tsched
from repro_torch.core import toy as ttoy
from repro_torch.launch import serve
from repro_torch.models import model as tmodel
from repro_torch.models.transformer import params_from_jax
from repro_torch.optim import adam as tadam
from repro_torch.serving import programs
from repro_torch.solvers import registry as treg
from torch_graph_double import CPUGraph

ITERS = 20


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Thousands of tiny eager ops a test: one torch thread beside the other
    test workers (as ``test_torch_bns.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def graphs(monkeypatch):
    monkeypatch.setattr(programs, "_graph_double", CPUGraph)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def toy():
    """``test_torch_bns.py``'s two-moons field and the reference's RK45 pairs."""
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


@pytest.fixture(scope="module")
def smoke():
    """yi-6b's smoke backbone (2 layers, f32), each layer recomputed in the
    backward as the launcher distils, with pairs made with numpy."""
    jcfg = jax_get_config("yi-6b", smoke=True)
    jparams = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    cfg = get_config("yi-6b", smoke=True)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    tok = np.random.default_rng(5).integers(0, cfg.vocab, size=(2, 8))
    field = tmodel.velocity_field(params, cfg, tsched.fm_ot(),
                                  {"tokens": torch.from_numpy(tok)}, remat=True)
    rng = np.random.default_rng(9)
    x0, x1, v0, v1 = rng.standard_normal((4, 2, 8, cfg.latent_dim)).astype(np.float32)
    return field, (x0, x1), (v0, v1)


def _t(p):
    return tuple(torch.from_numpy(np.array(a)) for a in p)


def _j(p):
    return tuple(jnp.asarray(a) for a in p)


def _train(trainer, field, train, val, **cfg):
    """One run of ``trainer`` (``bns``, ``bst`` or ``anytime``)."""
    cfg = tbns.BNSTrainConfig(**{"lr": 5e-3, "lr_schedule": "poly", "iterations": ITERS,
                                 "val_every": 5, "seed": 3, **cfg})
    if trainer == "anytime":
        return tanytime.train_anytime(field, [2, 4] if cfg.nfe == 4 else [4, 8],
                                      _t(train), _t(val), cfg)
    train_fn = tbns.train_bns if trainer == "bns" else tbns.train_bst
    return train_fn(field, _t(train), _t(val), cfg)


def _same_run(a, b):
    assert a.history == b.history
    assert a.val_psnr == b.val_psnr
    for x, y in zip(tadam.tree_leaves(a.params), tadam.tree_leaves(b.params)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("trainer", ["bns", "bst", "anytime"])
@pytest.mark.parametrize("where", ["toy", "smoke"])
def test_fit_graphed_equals_eager_to_the_bit(trainer, where, toy, smoke, monkeypatch):
    """20 iterations through the captured step and validation against the
    same run eager: params, history and the best iterate equal to the bit,
    and the graphed run did replay its programs. The toy field trains on
    mini-batches of 64 of 128 (gathered from the index table), the smoke
    backbone on full batches of 2."""
    if where == "toy":
        _, field, train, val = toy
        kw = dict(nfe=8 if trainer == "anytime" else 4, batch_size=64)
    else:
        field, train, val = smoke
        kw = dict(nfe=4, batch_size=2, init_solver="euler")
    eager = _train(trainer, field, train, val, **kw)
    monkeypatch.setattr(programs, "_graph_double", CPUGraph)
    graphed = _train(trainer, field, train, val, **kw)
    assert eager.programs["programs"] == 0
    assert (graphed.programs["programs"], graphed.programs["replays"]) == (2, ITERS - 1 + 3)
    _same_run(graphed, eager)
    assert [h[0] for h in graphed.history] == [5, 10, 15, 20]


def test_graphed_train_bns_matches_reference_for_20_iterations(toy, graphs):
    """``test_torch_bns.py::test_train_bns_matches_reference_for_20_iterations``
    through the programs, at its tolerances."""
    jfield, tfield, train, val = toy
    cfg = dict(nfe=4, init_solver="midpoint", lr=5e-3, lr_schedule="poly",
               iterations=20, batch_size=64, val_every=5, seed=3)
    want = jbns.train_bns(jfield, _j(train), _j(val), jbns.BNSTrainConfig(**cfg))
    got = tbns.train_bns(tfield, _t(train), _t(val), tbns.BNSTrainConfig(**cfg))
    assert got.programs["programs"] == 2
    assert [h[0] for h in got.history] == [h[0] for h in want.history] == [5, 10, 15, 20]
    np.testing.assert_allclose(np.array(got.history)[:, 1:], np.array(want.history)[:, 1:],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.val_psnr, want.val_psnr, rtol=1e-4)
    for g, w in zip(got.params, want.params):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-4, atol=1e-5)


def test_graphed_train_anytime_matches_reference_for_20_iterations(toy, graphs):
    """``test_torch_anytime.py::test_train_anytime_matches_reference_for_20_iterations``
    through the programs, at its tolerances."""
    jfield, tfield, train, val = toy
    cfg = dict(nfe=8, init_solver="midpoint", lr=5e-3, lr_schedule="poly", iterations=20,
               batch_size=64, val_every=5, seed=3)
    want = janytime.train_anytime(jfield, [4, 8], _j(train), _j(val),
                                  jbns.BNSTrainConfig(**cfg))
    got = tanytime.train_anytime(tfield, [4, 8], _t(train), _t(val),
                                 tbns.BNSTrainConfig(**cfg))
    assert got.programs["programs"] == 2
    assert [h[0] for h in got.history] == [h[0] for h in want.history] == [5, 10, 15, 20]
    np.testing.assert_allclose(np.array(got.history)[:, 1:], np.array(want.history)[:, 1:],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.val_psnr, want.val_psnr, rtol=1e-4)
    for name, g, w in zip(got.params._fields, got.params, want.params):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-4, atol=1e-5, err_msg=name)


def _loop(toy, iterations=ITERS, val_every=5, batch_size=64):
    _, field, train, val = toy
    cfg = tbns.BNSTrainConfig(nfe=4, init_solver="euler", lr=5e-3, lr_schedule="poly",
                              iterations=iterations, val_every=val_every,
                              batch_size=batch_size, seed=3)
    theta0 = tns.from_ns(treg.build_ns("euler", 4, None))
    return tbns.TrainLoop(*tbns.solver_objective(tbns.ns_sampler(field), _t(val), cfg),
                          theta0, _t(train), cfg)


def _line(it, loss, vp):
    return f"{it} {loss} {vp}"


def test_one_step_program_and_one_validation_program_a_run(toy, graphs):
    """As the reference jits one ``step`` and one ``val_psnr_fn``: the first
    call of each captures, every later one replays (iterations - 1 and
    validations - 1 times); the run reports both."""
    loop = _loop(toy)
    res = loop.run(line=_line)
    replays = {key[0][0]: p.replays for key, p in loop.programs.programs.items()}
    assert replays == {"step": ITERS - 1, "val": ITERS // 5 - 1}
    assert res.programs == loop.programs.stats()
    assert len(res.iteration_seconds) == ITERS


def test_the_learning_rate_is_gathered_at_adams_device_step(toy, graphs, monkeypatch):
    """A graph would bake a host number into every replay, so each update is
    handed a 0-d tensor gathered on the device at Adam's int32 step from
    the run's table, which holds the poly schedule's ``lr_fn(it)`` of every
    iteration as the reference computes it: the rate changes at every
    replay, as the reference's ``lr_fn(it)`` does."""
    seen = []
    real = tbns.adam_update_

    def spy(grads, state, params, lr, **kw):
        seen.append((lr, int(state.step)))
        return real(grads, state, params, lr, **kw)

    monkeypatch.setattr(tbns, "adam_update_", spy)
    loop = _loop(toy)
    poly = tbns.poly_decay(5e-3, ITERS)
    assert loop.rates.dtype == torch.float32
    assert loop.rates.tolist() == [float(poly(it)) for it in range(ITERS)]
    assert loop.opt.step.dtype == torch.int32 and loop.opt.step.dim() == 0
    loop.run(line=_line)
    assert all(isinstance(lr, torch.Tensor) and lr.dim() == 0 for lr, _ in seen)
    # the warm-up is iteration 0; the capture then runs on iteration 1's
    # state (the double undoes its writes) before iteration 1 replays
    steps = [0, 1] + list(range(1, ITERS))
    assert [step for _, step in seen] == steps
    assert [float(lr) for lr, _ in seen] == [float(poly(it)) for it in steps]
    assert len({float(lr) for lr, _ in seen}) == ITERS


def test_theta_and_adam_leaves_keep_their_addresses(toy, graphs, monkeypatch):
    """A graph holds theta, mu, nu and step by address: every update writes
    into the same tensors, from the first iteration to the last."""
    seen = []
    real = tbns.adam_update_

    def spy(grads, state, params, lr, **kw):
        seen.append(tuple(x.data_ptr() for x in tadam.tree_leaves((params, state))))
        return real(grads, state, params, lr, **kw)

    monkeypatch.setattr(tbns, "adam_update_", spy)
    loop = _loop(toy)
    addresses = tuple(x.data_ptr() for x in tadam.tree_leaves((loop.theta, loop.opt)))
    loop.run(line=_line)
    assert len(seen) == ITERS + 1 and set(seen) == {addresses}
    assert int(loop.opt.step) == ITERS


def test_the_index_table_equals_the_references_draws(monkeypatch):
    """The whole run's mini-batches drawn up front are the ones the
    reference's loop draws one iteration at a time: its ``rng.choice``
    calls, recorded while ``repro.core.bns.train_solver`` runs."""
    drawn = []
    real_rng = np.random.default_rng

    class Recorder:
        def __init__(self, seed):
            self.rng = real_rng(seed)

        def choice(self, *a, **kw):
            drawn.append(self.rng.choice(*a, **kw))
            return drawn[-1]

    rng = np.random.default_rng(4)
    x = jnp.asarray(rng.standard_normal((40, 2)).astype(np.float32))
    jfield = jtoy.linear_field(jsched.fm_ot())
    cfg = jbns.BNSTrainConfig(nfe=2, init_solver="euler", iterations=7, batch_size=16,
                              val_every=100, seed=11)
    monkeypatch.setattr(np.random, "default_rng", Recorder)
    jbns.train_bns(jfield, (x, x), (x, x), cfg)
    monkeypatch.setattr(np.random, "default_rng", real_rng)
    table = tbns.batch_table(11, 40, 16, 7, "cpu")
    assert table.dtype == torch.int64 and tuple(table.shape) == (7, 16)
    np.testing.assert_array_equal(table.numpy(), np.stack(drawn))
    assert tbns.batch_table(11, 40, 40, 7, "cpu") is None      # full batch: no draws


def test_disabled_trains_eagerly(toy, graphs):
    """``programs.disabled()`` (``jax.disable_jit()``) captures nothing and
    gives the graphed run's bits."""
    graphed = _loop(toy).run(line=_line)
    with programs.disabled():
        eager = _loop(toy).run(line=_line)
    assert eager.programs == {"programs": 0, "replays": 0, "capture_ms": 0.0}
    _same_run(graphed, eager)


def test_the_cpu_trains_eagerly_without_the_double(toy):
    res = _loop(toy, iterations=3).run(line=_line)
    assert res.programs == {"programs": 0, "replays": 0, "capture_ms": 0.0}


def test_a_failed_capture_raises(toy, monkeypatch):
    """No eager fallback: a step whose capture fails stops the run."""
    class Broken(CPUGraph):
        def capture(self, run, state):
            raise RuntimeError("capture failed")

    monkeypatch.setattr(programs, "_graph_double", Broken)
    loop = _loop(toy)
    with pytest.raises(RuntimeError, match="capture failed"):
        loop.run(line=_line)
    assert len(loop.programs) == 0


def test_the_launchers_closing_line_counts_the_training_programs(graphs, capsys):
    """``--bns-iters 3``: the served sampler's program and the training's
    step and validation, 2 replays of the step and 1 of the request's
    program."""
    served = serve.main(["--arch", "yi-6b", "--mode", "flow", "--nfe", "2", "--batch", "2",
                         "--seq", "4", "--bns-iters", "3", "--requests", "2",
                         "--device", "cpu"])
    assert served.distillation.programs["programs"] == 2
    assert served.distillation.programs["replays"] == 2
    assert set(served.distillation.pairs) == {"train", "val"}
    assert "programs captured: 3, replays 3, capture" in capsys.readouterr().out


@pytest.mark.parametrize("base", ["euler", "midpoint"])
def test_bst_programs_read_only_device_tensors(toy, graphs, base):
    """BST's step takes the knots through ``run_direct`` as tensors (never a
    host number): the captured and eager runs agree to the bit for either
    base solver."""
    _, field, train, val = toy
    cfg = tbns.BNSTrainConfig(nfe=4, lr=5e-3, iterations=6, val_every=3, batch_size=64)
    graphed = tbns.train_bst(field, _t(train), _t(val), cfg, base=base)
    with programs.disabled():
        eager = tbns.train_bst(field, _t(train), _t(val), cfg, base=base)
    assert graphed.programs["programs"] == 2
    _same_run(graphed, eager)
    assert not all(torch.equal(p, q) for p, q in
                   zip(graphed.params, bst_solver.identity_bst(4, base)))


def test_warm_up_and_capture_leave_one_iteration(toy, graphs):
    """The first step is iteration 0 (the capture's warm-up); the capture
    that follows changes nothing, so after k steps Adam has counted k."""
    loop = _loop(toy)
    for k in range(1, 4):
        loop.step()
        assert int(loop.opt.step) == k
    assert len(loop.programs) == 1 and loop.programs.replays == 2
