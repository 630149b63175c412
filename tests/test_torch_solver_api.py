"""The port's solver product API (``repro_torch.solvers`` and
``repro_torch.checkpoint``) against ``repro.solvers``, on the CPU.

Mirrors ``tests/test_solver_api.py`` and adds what the port must share with
the reference: artifacts written by either package load in the other with
bit-equal parameters (``ns``, ``bns``, ``bst``, ``anytime``), the same
solver and meta give byte-identical files, and a JAX-written artifact serves
the reference's samples. The generic solvers' NS parameters equal the
reference's to the bit; ddim, dpm2m and edm_heun compute theirs through f32
``exp``/``log``/``sin``, where XLA and torch differ by an ulp, and agree to
f32 TOL. The toy
field is the two-moons mixture of ``tests/test_bns.py``; pairs are numpy
x0 from a seed and the reference's RK45 solve of it.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpointer as jckpt
from repro.core import anytime as janytime
from repro.core import bst_solver as jbst
from repro.core import ns_solver as jns
from repro.core import schedulers as jsched
from repro.core import toy as jtoy
from repro.core.bns import BNSTrainConfig as JaxTrainConfig
from repro.core.rk45 import rk45_solve as jax_rk45
from repro.solvers import SolverArtifact as JaxArtifact
from repro.solvers import SolverSpec as JaxSpec
from repro_torch.checkpoint import checkpointer
from repro_torch.core import anytime
from repro_torch.core import bst_solver as tbst
from repro_torch.core import ns_solver as tns
from repro_torch.core import schedulers as tsched
from repro_torch.core import toy as ttoy
from repro_torch.core.bns import BNSTrainConfig, solver_to_ns
from repro_torch.solvers import (
    MODES,
    SolverArtifact,
    SolverSpec,
    build_ns,
    get_solver,
    ns_at_budget,
    reduce_to_ns,
    solver_names,
)
from repro_torch.solvers.artifact import FORMAT, FORMAT_VERSION, _param_template

NFE = 8
TOL = 2e-5


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
def fields():
    jfield = jtoy.mixture_field(jsched.fm_ot(), jtoy.two_moons_means(),
                                jnp.full((16,), 0.15), jnp.ones((16,)))
    tfield = ttoy.mixture_field(tsched.fm_ot(), ttoy.two_moons_means(),
                                torch.full((16,), 0.15), torch.ones((16,)))
    return jfield, tfield


@pytest.fixture(scope="module")
def pairs(fields):
    """(train, val) as numpy: x0 from a seed, x1 the reference's RK45 solve."""
    jfield, _ = fields
    solve = jax.jit(lambda x: jax_rk45(jfield.fn, x, rtol=1e-5, atol=1e-5).x1)
    out = []
    for seed in (0, 1):
        x0 = np.random.default_rng(seed).standard_normal((64, 2)).astype(np.float32)
        out.append((x0, np.asarray(solve(jnp.asarray(x0)))))
    return tuple(out)


def _t(p):
    return tuple(torch.tensor(a) for a in p)


def _equal_leaves(port_tree, ref_tree):
    ref = jax.tree.leaves(ref_tree)
    got = list(port_tree)
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert a.dtype == torch.float32 and np.asarray(b).dtype == np.float32
        np.testing.assert_array_equal(_np(a), np.asarray(b))


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", solver_names())
def test_registry_matches_solver_to_ns_and_the_reference(fields, name):
    """spec.build == the deprecated solver_to_ns path, bit for bit, and ==
    the reference's spec.build at NFE 8; their samples agree."""
    jfield, tfield = fields
    new = SolverSpec(name, NFE).build(tfield)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        old = solver_to_ns(name, NFE, tfield)
    for a, b in zip(new, old):
        assert torch.equal(a, b), name
    if get_solver(name).family == "generic":
        _equal_leaves(new, JaxSpec(name, NFE).build(jfield))
    else:
        for a, b in zip(new, JaxSpec(name, NFE).build(jfield)):
            np.testing.assert_allclose(_np(a), np.asarray(b), rtol=TOL, atol=TOL)
    x0 = np.random.default_rng(0).standard_normal((16, 2)).astype(np.float32)
    with torch.no_grad():
        got = tns.ns_sample(new, tfield.fn, torch.from_numpy(x0))
    want = jns.ns_sample(JaxSpec(name, NFE).build(jfield), jfield.fn, jnp.asarray(x0))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=TOL, atol=TOL * NFE)


def test_registry_contents_and_capabilities():
    """The reference's test_registry_contents_and_capabilities, and the
    reference's names in its order (the families of ROADMAP Queue A item 2
    were refused here before they were ported)."""
    from repro.solvers import registry as jreg

    assert solver_names() == jreg.solver_names()
    assert set(solver_names()) >= {"euler", "midpoint", "heun", "rk4", "ab2", "ab4",
                                   "ddim", "dpm2m", "edm_heun"}
    assert set(solver_names(baseline=True)) == {"euler", "midpoint", "ddim", "dpm2m"}
    assert set(solver_names(family="exponential")) == {"ddim", "dpm2m"}
    assert "edm_heun" in solver_names(family="scale-time")
    assert solver_names(family="generic", baseline=True) == ["euler", "midpoint"]
    assert set(solver_names(supports_sigma0=True)) == set(solver_names(family="generic"))
    assert get_solver("ddim").grid_family == "lambda"
    assert get_solver("ddim").needs_scheduler and not get_solver("ddim").supports_sigma0
    assert get_solver("rk4").evals_per_interval == 4
    assert get_solver("midpoint").valid_nfe(8) and not get_solver("midpoint").valid_nfe(7)


def test_registry_unknown_and_bad_sigma0(fields):
    jfield, tfield = fields
    with pytest.raises(KeyError):
        build_ns("nonexistent", NFE, tfield)
    with pytest.raises(ValueError, match="sigma0"):
        build_ns("ddim", NFE, tfield, sigma0=2.0)
    # sigma0 != 1 on a generic solver is preconditioning (once refused naming
    # ROADMAP Queue A item 2): the reference's parameters
    for a, b in zip(SolverSpec("euler", NFE, sigma0=3.0).build(tfield),
                    JaxSpec("euler", NFE, sigma0=3.0).build(jfield)):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=TOL, atol=TOL)


def test_solver_to_ns_shim_warns(fields):
    with pytest.warns(DeprecationWarning):
        solver_to_ns("euler", NFE, fields[1])


def test_grid_override(fields):
    jfield, tfield = fields
    grid = np.linspace(0.0, 1.0, NFE + 1) ** 2.0
    ns = SolverSpec("euler", NFE, grid=tuple(grid)).build(tfield)
    assert float((ns.times - torch.from_numpy(grid[:-1]).float()).abs().max()) < 1e-6
    _equal_leaves(ns, JaxSpec("euler", NFE, grid=tuple(grid)).build(jfield))


# ---------------------------------------------------------------------------
# SolverSpec
# ---------------------------------------------------------------------------


def test_spec_distill_bns_smoke(fields, pairs):
    _, tfield = fields
    train, val = (_t(p) for p in pairs)
    spec = SolverSpec("midpoint", 4, mode="bns")
    res = spec.distill(tfield, train, val, BNSTrainConfig(iterations=80, val_every=20,
                                                          batch_size=32))
    assert res.spec is spec and res.history
    assert res.num_parameters == tns.count_parameters(4)
    baseline = SolverSpec("midpoint", 4).sampler(tfield).psnr(val)
    assert res.val_psnr > baseline
    assert bool(torch.isfinite(res.ns_params.b).all())


def test_spec_distill_bns_matches_the_reference(fields, pairs):
    """20 iterations through each package's spec.distill from the same
    pairs: val PSNR and the materialized solver agree (rtol 1e-4, as
    tests/test_torch_bns.py holds train_bns)."""
    jfield, tfield = fields
    kw = dict(iterations=20, val_every=5, batch_size=32, lr=5e-3, seed=2)
    spec = ("midpoint", 4)
    want = JaxSpec(*spec, mode="bns").distill(
        jfield, *(tuple(jnp.asarray(a) for a in p) for p in pairs), JaxTrainConfig(**kw))
    got = SolverSpec(*spec, mode="bns").distill(tfield, *(_t(p) for p in pairs),
                                                BNSTrainConfig(**kw))
    np.testing.assert_allclose(got.val_psnr, want.val_psnr, rtol=1e-4)
    for a, b in zip(got.ns_params, want.ns_params):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-4, atol=1e-5)
    assert got.num_parameters == want.num_parameters


def test_spec_distill_baseline_mode(fields, pairs):
    _, tfield = fields
    val = _t(pairs[1])
    res = SolverSpec("euler", NFE).distill(tfield, None, val)
    assert res.val_psnr == pytest.approx(SolverSpec("euler", NFE).sampler(tfield).psnr(val))
    assert isinstance(res.ns_params, tns.NSParams) and res.history == []


def test_spec_anytime_normalizes_budgets():
    spec = SolverSpec("midpoint", mode="anytime", budgets=(8, 4))
    assert spec.budgets == (4, 8) and spec.nfe == 8
    with pytest.raises(ValueError):
        SolverSpec("midpoint", mode="anytime")
    with pytest.raises(ValueError):
        SolverSpec("midpoint", mode="nonsense")
    assert MODES == ("baseline", "bns", "bst", "anytime")


def test_spec_bst_mode_names_item_2(fields):
    """BST mode, once refused naming ROADMAP Queue A item 2: a spec the
    reference's is key for key, and a base other than euler or midpoint is
    refused at distill, as there."""
    spec = SolverSpec("euler", 4, mode="bst")
    assert spec.to_dict() == JaxSpec("euler", 4, mode="bst").to_dict()
    with pytest.raises(ValueError, match="euler or midpoint"):
        SolverSpec("heun", 4, mode="bst").distill(fields[1], None, None)


SPECS = [dict(name="euler", nfe=8),
         dict(name="midpoint", nfe=4, sigma0=2.0, cfg_scale=1.5, mode="bns"),
         dict(name="midpoint", mode="anytime", budgets=(8, 4)),
         dict(name="euler", nfe=8, grid=tuple(i / 8 for i in range(9))),
         dict(name="euler", nfe=8, grid=[0, 0.5, 1.0])]


@pytest.mark.parametrize("kw", SPECS)
def test_spec_dict_roundtrip_key_for_key_with_the_reference(kw):
    """to_dict is the reference's key for key; from_dict of either package's
    dict gives the same (hashable) spec, with grid and budgets as tuples."""
    spec, ref = SolverSpec(**kw), JaxSpec(**kw)
    assert spec.to_dict() == ref.to_dict()
    assert list(spec.to_dict()) == list(ref.to_dict())
    for d in (spec.to_dict(), ref.to_dict()):
        back = SolverSpec.from_dict(d)
        assert back == spec and hash(back) == hash(spec)
        assert back.grid is None or type(back.grid) is tuple
        assert back.budgets is None or type(back.budgets) is tuple
    assert {SolverSpec.from_dict(spec.to_dict()): 1}[spec] == 1


# ---------------------------------------------------------------------------
# SolverArtifact
# ---------------------------------------------------------------------------


def test_artifact_roundtrip_bit_exact(fields, pairs, tmp_path):
    _, tfield = fields
    train, val = (_t(p) for p in pairs)
    spec = SolverSpec("midpoint", 4, mode="bns")
    res = spec.distill(tfield, train, val, BNSTrainConfig(iterations=40, val_every=20,
                                                          batch_size=32))
    art = res.artifact(provenance={"source": "test"})
    path = str(tmp_path / "solver.msgpack")
    art.save(path)
    art2 = SolverArtifact.load(path)
    assert art2.spec == spec and art2.kind == "bns"
    assert art2.val_psnr == pytest.approx(res.val_psnr)
    assert art2.provenance == {"source": "test"}
    for a, b in zip(art.params, art2.params):
        assert torch.equal(a, b)
    assert torch.equal(art.sampler(tfield)(val[0]), art2.sampler(tfield)(val[0]))


def test_artifact_baseline_roundtrip(fields, pairs, tmp_path):
    """The reference's case: a ddim baseline (no training) round trips."""
    _, tfield = fields
    val = _t(pairs[1])
    res = SolverSpec("ddim", NFE).distill(tfield, None, val)
    assert res.num_parameters > 0 and np.isfinite(res.val_psnr)
    path = str(tmp_path / "ddim.msgpack")
    res.artifact().save(path)
    art = SolverArtifact.load(path)
    assert art.kind == "ns"
    assert torch.equal(art.sampler(tfield)(val[0]), res.sampler(tfield)(val[0]))


def test_artifact_rejects_non_artifact(tmp_path):
    path = str(tmp_path / "raw.msgpack")
    checkpointer.save(path, {"w": torch.zeros((2,))})
    with pytest.raises(ValueError):
        SolverArtifact.load(path)


def test_reduce_to_ns_anytime_error_names_escape_hatch():
    theta = anytime.init_anytime(None, (2, 4))
    with pytest.raises(TypeError, match="ns_at_budget"):
        reduce_to_ns(theta)
    assert ns_at_budget(theta, (2, 4), 2).n == 2


def test_anytime_artifact_roundtrips_and_serves(fields, pairs, tmp_path):
    _, tfield = fields
    train, val = (_t(p) for p in pairs)
    budgets = (2, 4)
    spec = SolverSpec("midpoint", mode="anytime", budgets=budgets)
    res = spec.distill(tfield, train, val, BNSTrainConfig(iterations=40, val_every=20,
                                                          batch_size=32))
    assert res.budgets == budgets
    path = str(tmp_path / "anytime.msgpack")
    res.artifact(provenance={"source": "test"}).save(path)
    art = SolverArtifact.load(path)
    assert art.kind == "anytime" and art.spec == spec and art.budgets == budgets
    with pytest.raises(TypeError):
        art.ns_params
    x0 = val[0]
    for m in budgets:
        ns = art.ns_at_budget(m)
        assert ns.n == m
        for a, b in zip(res.ns_at_budget(m), ns):
            assert torch.equal(a, b)
        out = art.sampler(tfield, budget=m)(x0)
        assert out.shape == x0.shape and bool(torch.isfinite(out).all())
    assert torch.equal(art.sampler(tfield)(x0), art.sampler(tfield, budget=4)(x0))
    assert art.nearest_budget(3) == 2 and art.nearest_budget(100) == 4
    with pytest.raises(ValueError):
        art.ns_at_budget(3)


# ---------------------------------------------------------------------------
# The file format, shared with the reference
# ---------------------------------------------------------------------------


def _reference_artifacts(jfield):
    """One JAX artifact of each kind the port serves, with params jittered
    from a seed so no leaf is structural zeros."""
    rng = np.random.default_rng(7)

    def jitter(tree):
        return jax.tree.map(lambda x: x + jnp.asarray(
            0.05 * rng.standard_normal(x.shape), jnp.float32), tree)

    ns = JaxSpec("midpoint", 4).build(jfield)
    return {
        "ns": JaxArtifact(spec=JaxSpec("midpoint", 4), params=jitter(ns), val_psnr=21.5,
                          provenance={"arch": "toy"}),
        "bns": JaxArtifact(spec=JaxSpec("euler", 4, mode="bns", cfg_scale=1.5),
                           params=jitter(jns.from_ns(JaxSpec("euler", 4).build(jfield))),
                           val_psnr=23.25, provenance={"seed": 3}),
        "anytime": JaxArtifact(spec=JaxSpec("midpoint", mode="anytime", budgets=(2, 4, 8)),
                               params=jitter(janytime.init_anytime(None, (2, 4, 8))),
                               val_psnr=19.0),
        "bst": JaxArtifact(spec=JaxSpec("midpoint", 4, mode="bst"),
                           params=jitter(jbst.identity_bst(4, "midpoint")), val_psnr=20.5,
                           provenance={"base": "midpoint"}),
    }


def _port_twin(art):
    conv = {"ns": tns.ns_params_from_numpy, "bns": tns.bns_params_from_numpy,
            "anytime": anytime.anytime_params_from_numpy,
            "bst": tbst.bst_params_from_numpy}[art.kind]
    return SolverArtifact(spec=SolverSpec.from_dict(art.spec.to_dict()),
                          params=conv(*(np.asarray(x) for x in art.params)),
                          val_psnr=art.val_psnr, provenance=dict(art.provenance))


@pytest.mark.parametrize("kind", ["ns", "bns", "anytime", "bst"])
def test_reference_artifact_loads_in_the_port_bit_equal(fields, tmp_path, kind):
    ref = _reference_artifacts(fields[0])[kind]
    path = str(tmp_path / f"{kind}.msgpack")
    ref.save(path)
    art = SolverArtifact.load(path)
    assert art.kind == kind and type(art.params).__name__ == type(ref.params).__name__
    assert art.spec.to_dict() == ref.spec.to_dict() and art.budgets == ref.budgets
    assert (art.val_psnr, art.provenance) == (ref.val_psnr, ref.provenance)
    _equal_leaves(art.params, ref.params)


@pytest.mark.parametrize("kind", ["ns", "bns", "anytime", "bst"])
def test_port_artifact_loads_in_the_reference_bit_equal(fields, tmp_path, kind):
    ref = _reference_artifacts(fields[0])[kind]
    path = str(tmp_path / f"{kind}.msgpack")
    _port_twin(ref).save(path)
    back = JaxArtifact.load(path)
    assert back.kind == kind and back.spec == ref.spec
    assert (back.val_psnr, back.provenance) == (ref.val_psnr, ref.provenance)
    _equal_leaves(_port_twin(back).params, ref.params)
    for a, b in zip(jax.tree.leaves(back.params), jax.tree.leaves(ref.params)):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


@pytest.mark.parametrize("kind", ["ns", "bns", "anytime", "bst"])
def test_port_writes_byte_identical_files(fields, tmp_path, kind):
    ref = _reference_artifacts(fields[0])[kind]
    ref.save(str(tmp_path / "ref.msgpack"))
    _port_twin(ref).save(str(tmp_path / "port.msgpack"))
    assert (tmp_path / "port.msgpack").read_bytes() == (tmp_path / "ref.msgpack").read_bytes()
    assert checkpointer.load_meta(str(tmp_path / "port.msgpack"))["format"] == FORMAT
    assert checkpointer.load_meta(str(tmp_path / "port.msgpack"))["version"] == FORMAT_VERSION


def test_checkpointer_trees_and_steps_match_the_reference(tmp_path):
    """Dict trees go in sorted-key order (jax.tree.leaves'), restore keeps
    the template's structure and dtype, and the step helpers agree."""
    rng = np.random.default_rng(1)
    tree = {"b": rng.standard_normal((3,)).astype(np.float32),
            "a": [rng.standard_normal((2, 2)).astype(np.float32), np.int32(7)]}
    jckpt.save(str(tmp_path / "ref.msgpack"), jax.tree.map(jnp.asarray, tree), meta={"k": 1})
    port_tree = {"b": torch.from_numpy(tree["b"]),
                 "a": [torch.from_numpy(tree["a"][0]), torch.tensor(7, dtype=torch.int32)]}
    checkpointer.save(str(tmp_path / "port.msgpack"), port_tree, meta={"k": 1})
    assert (tmp_path / "port.msgpack").read_bytes() == (tmp_path / "ref.msgpack").read_bytes()
    back = checkpointer.restore(str(tmp_path / "ref.msgpack"), port_tree)
    assert list(back) == ["b", "a"] and back["a"][1].dtype == torch.int32
    np.testing.assert_array_equal(back["a"][0].numpy(), tree["a"][0])
    assert checkpointer.load_meta(str(tmp_path / "ref.msgpack")) == {"k": 1}
    for step in (3, 12):
        checkpointer.save(checkpointer.step_path(str(tmp_path / "ck"), step), port_tree)
    assert checkpointer.latest_step(str(tmp_path / "ck")) == jckpt.latest_step(
        str(tmp_path / "ck")) == 12
    assert checkpointer.latest_step(str(tmp_path / "none")) is None
    assert checkpointer.step_path("d", 5) == jckpt.step_path("d", 5)


def test_bst_artifact_is_refused_naming_item_2(fields, tmp_path):
    """A reference BST artifact (once refused on load, naming ROADMAP Queue A
    item 2) loads in the port with bit-equal parameters and is never served
    as something else: its ns_params raise TypeError, as the reference's."""
    from repro.core import bst_solver

    spec = JaxSpec("euler", 4, mode="bst")
    k = bst_solver.knot_positions(4, "euler").shape[0]
    rng = np.random.default_rng(4)
    params = bst_solver.BSTParams(*(jnp.asarray(rng.standard_normal(n), jnp.float32)
                                    for n in (k - 1, k, k, k)))
    path = str(tmp_path / "bst.msgpack")
    JaxArtifact(spec=spec, params=params, val_psnr=0.0).save(path)
    art = SolverArtifact.load(path)
    assert art.kind == "bst" and art.spec == SolverSpec("euler", 4, mode="bst")
    _equal_leaves(art.params, params)
    with pytest.raises(TypeError, match="BSTParams"):
        art.ns_params
    assert [tuple(x.shape) for x in _param_template("bst", SolverSpec("euler", 4))] == \
        [(k - 1,), (k,), (k,), (k,)]


def test_param_templates_match_the_reference():
    for kind, spec in [("ns", ("euler", 5)), ("bns", ("euler", 5)),
                       ("bst", ("midpoint", 6)), ("anytime", ("midpoint", 8))]:
        kw = dict(mode="anytime", budgets=(2, 8)) if kind == "anytime" else {}
        from repro.solvers.artifact import _param_template as jtemplate

        ref = jtemplate(kind, JaxSpec(*spec, **kw))
        got = _param_template(kind, SolverSpec(*spec, **kw))
        assert type(got).__name__ == type(ref).__name__
        assert [tuple(x.shape) for x in got] == [x.shape for x in jax.tree.leaves(ref)]


# ---------------------------------------------------------------------------
# Serving from an artifact
# ---------------------------------------------------------------------------


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


def test_flow_sampler_from_artifact(smoke, tmp_path):
    from repro_torch.models import model as tmodel
    from repro_torch.serving.engine import FlowSampler

    _, _, cfg, params, tok = smoke
    batch = {"tokens": torch.from_numpy(tok)}
    field = tmodel.velocity_field(params, cfg, tsched.fm_ot(), batch)
    res = SolverSpec("midpoint", 4).distill(
        field, None, (torch.randn((2, 8, cfg.latent_dim), generator=torch.Generator()
                                 .manual_seed(1)), torch.zeros((2, 8, cfg.latent_dim))))
    path = str(tmp_path / "serve.msgpack")
    res.artifact().save(path)
    art = SolverArtifact.load(path)
    sampler = FlowSampler.from_artifact(art, params=params, cfg=cfg, sched=tsched.fm_ot())
    direct = FlowSampler(params=params, cfg=cfg, sched=tsched.fm_ot(), solver=res.ns_params)
    a = sampler.sample(batch, torch.Generator().manual_seed(2))
    b = direct.sample(batch, torch.Generator().manual_seed(2))
    assert torch.equal(a, b)


@pytest.mark.parametrize("kind,budget", [("ns", None), ("bns", None), ("anytime", 2),
                                         ("anytime", 8)])
def test_reference_artifact_serves_the_reference_samples(smoke, tmp_path, kind, budget):
    """A JAX-written artifact, served by the port's FlowSampler.from_artifact,
    against the reference's FlowSampler.from_artifact on the same x0 (f32
    TOL, scaled by NFE as tests/test_torch_serve.py scales it)."""
    from repro.core import schedulers as js
    from repro.serving.engine import FlowSampler as JaxFlowSampler
    from repro_torch.serving.engine import FlowSampler

    jcfg, jparams, cfg, params, tok = smoke
    ref = _reference_artifacts(None if kind == "anytime" else jtoy.mixture_field(
        jsched.fm_ot(), jtoy.two_moons_means(), jnp.full((16,), 0.15),
        jnp.ones((16,))))[kind]
    path = str(tmp_path / "ref.msgpack")
    ref.save(path)
    x0 = np.random.default_rng(9).standard_normal((2, 8, cfg.latent_dim)).astype(np.float32)
    want = JaxFlowSampler.from_artifact(JaxArtifact.load(path), params=jparams, cfg=jcfg,
                                        sched=js.fm_ot(), budget=budget
                                        ).sample_from({"tokens": jnp.asarray(tok)},
                                                      jnp.asarray(x0))
    sampler = FlowSampler.from_artifact(SolverArtifact.load(path), params=params, cfg=cfg,
                                        sched=tsched.fm_ot(), budget=budget)
    got = sampler.sample_from({"tokens": torch.from_numpy(tok)}, x0)
    n = sampler.solver.n
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL * n, atol=TOL * n)
