"""The examples' twins (``examples/torch``) on the CPU at their smallest
sizes, and, where a twin takes explicit inputs, those inputs through the
reference's own calls.

Inputs are made with numpy and handed to both packages (the twins' own
noise comes from ``torch.Generator``s, which cannot reproduce threefry's
draws). Limits: f32 TOL 2e-5 (``tests/test_kernels.py``) on sampler
outputs; PSNRs, which are -10 log10 of a mean square over the same outputs,
within 1e-3 dB.
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import ns_solver as jns
from repro.core import schedulers as jsched
from repro.core import solvers as jsolvers
from repro.core import st_solvers as jst
from repro.core import st_transform as jstt
from repro.core import taxonomy as jtax
from repro.core import toy as jtoy
from repro.core.bst_solver import bst_euler_program, identity_bst, materialize_bst
from repro.core.exponential import ddim_program, dpm2m_program, exp_grid
from repro.core.rk45 import rk45_solve
from repro.models import model as jmodel
from repro.serving import engine as jengine
from repro.solvers import SolverSpec as JSolverSpec
from repro_torch.configs import get_config
from repro_torch.models import mamba2, moe, rwkv6, transformer

ROOT = Path(__file__).resolve().parents[1]
TOL = 2e-5                       # tests/test_kernels.py, f32
PSNR_TOL = 1e-3                  # dB


def _twin(name):
    spec = importlib.util.spec_from_file_location(f"twin_{name}",
                                                  ROOT / "examples" / "torch" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jmixture(sched):
    return jtoy.mixture_field(sched, jtoy.two_moons_means(), jnp.full((16,), 0.15),
                              jnp.ones((16,)))


@pytest.mark.parametrize("name", ["quickstart", "solver_zoo", "gateway_demo",
                                  "serve_decode", "train_flow_lm"])
def test_twin_without_a_card_exits_with_a_message(name, capsys):
    """The default device is the card: without one the twin exits non-zero
    and says how to run on the CPU, before it does any work."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(SystemExit) as info:
        _twin(name).main([])
    assert info.value.code not in (0, None) and "--device cpu" in str(info.value.code)


def test_quickstart_runs_and_bns_wins():
    """At 64 pairs and 100 iterations BNS beats every baseline (the twin
    asserts it) and every registered baseline is scored."""
    from repro_torch.solvers import list_solvers

    scores = _twin("quickstart").main(["--device", "cpu", "--pairs", "64",
                                       "--iterations", "100"])
    assert set(scores) == {i.name for i in list_solvers(baseline=True)} | {"BNS (ours)"}
    assert scores["BNS (ours)"] == max(scores.values())


def test_quickstart_baselines_match_the_reference_on_the_same_pairs():
    """The baselines' PSNR at NFE 8 on the same pairs: x0 from numpy, x1 the
    reference's RK45 solution of its mixture field."""
    twin = _twin("quickstart")
    x0 = np.random.default_rng(0).standard_normal((64, 2)).astype(np.float32)
    jfield = _jmixture(jsched.fm_ot())
    x1 = np.array(rk45_solve(jfield.fn, jnp.asarray(x0), rtol=1e-5, atol=1e-5).x1)
    got = twin.baseline_scores(twin.mixture("cpu"), (torch.from_numpy(x0), torch.from_numpy(x1)))
    want = {name: JSolverSpec(name, twin.NFE).sampler(jfield).psnr((jnp.asarray(x0),
                                                                     jnp.asarray(x1)))
            for name in got}
    for name in got:
        assert abs(got[name] - float(want[name])) <= PSNR_TOL, (name, got[name], want[name])


def _jcases(sched):
    """examples/solver_zoo.py's rows, as the reference builds them."""
    out = [(name, jsolvers.solver_program(name), (jsolvers.grid_for_nfe(name, 8),))
           for name in ["euler", "midpoint", "heun", "rk4", "ab2", "ab4"]]
    out += [("ddim", ddim_program, (exp_grid(sched, 8), sched)),
            ("dpm++(2M)", dpm2m_program, (exp_grid(sched, 8), sched)),
            ("edm+heun", jst.edm_program(jsolvers.heun_program, sched, 20.0),
             (jsolvers.power_grid(4, 3.0),))]
    st = jstt.scheduler_change_st(sched, jstt.scaled_sigma(sched, 3.0))
    out += [("precond-euler s0=3", jst.st_program(jsolvers.euler_program, st),
             (jsolvers.uniform_grid(8),)),
            ("bst-euler", bst_euler_program, (materialize_bst(identity_bst(8)),))]
    return out


def test_solver_zoo_matches_the_reference_on_the_same_x0(capsys):
    """Each row's NS output equals the reference's within f32 TOL, and its
    largest |direct - NS| is at or below the reference's (or within f32
    rounding of the outputs, where the reference's is itself an ulp)."""
    twin = _twin("solver_zoo")
    x0 = np.random.default_rng(0).standard_normal((16, 2)).astype(np.float32)
    rows = twin.rows(twin.mixture("cpu"), torch.from_numpy(x0))
    jfield = _jmixture(jsched.vp())
    jrows = _jcases(jfield.scheduler)
    assert [r["name"] for r in rows] == [name for name, _, _ in jrows]
    for r, (name, prog, args) in zip(rows, jrows):
        direct = jtax.run_direct(prog, jfield, jnp.asarray(x0), *args)
        ns = jtax.to_ns(prog, *args)
        alg1 = jns.ns_sample(ns, jfield.fn, jnp.asarray(x0))
        jerr = float(jnp.max(jnp.abs(direct - alg1)))
        assert r["n"] == ns.n
        np.testing.assert_allclose(r["ns"].numpy(), np.asarray(alg1), atol=TOL, rtol=TOL,
                                   err_msg=name)
        ulp = float(np.spacing(np.abs(np.asarray(alg1)).max()))
        assert r["err"] <= max(jerr, 4 * ulp), (name, r["err"], jerr)
    twin.main(["--device", "cpu"])
    assert "registry (9 solvers)" in capsys.readouterr().out


def test_gateway_demo_serves_the_references_budgets():
    """12 requests over budgets {2, 4}: each served at the reference's
    ``nearest_budget`` of its requested budget (3 drifts), with the drift in
    the metadata."""
    out = _twin("gateway_demo").main(["--device", "cpu"])
    requested = [(2, 4, 3)[i % 3] for i in range(12)]
    assert [m["requested_budget"] for m in out["metas"]] == requested
    assert [m["served_budget"] for m in out["metas"]] == [
        jengine.nearest_budget((2, 4), b) for b in requested]
    assert out["stats"]["completed"] == 12
    assert all(m["batch_real"] <= m["batch_padded"] for m in out["metas"])


@pytest.mark.parametrize("arch,module,window", [
    ("yi-6b", transformer, 0), ("yi-6b", transformer, 8), ("rwkv6-7b", rwkv6, 0),
    ("zamba2-2.7b", mamba2, 0), ("qwen3-moe-30b-a3b", moe, 0)])
def test_serve_decode_greedy_tokens_match_the_reference(arch, module, window):
    """Each family's greedy demo on the reference's weights (seed 0, carried
    across): the same tokens as the reference's ``greedy_demo``."""
    jcfg = jax_get_config(arch, smoke=True)
    tree = jax.tree.map(np.asarray, jmodel.init_params(jax.random.PRNGKey(0), jcfg))
    slots = 8 if window else 64
    want, _ = jengine.greedy_demo(jengine.DecodeEngine(params=jax.tree.map(jnp.asarray, tree),
                                                       cfg=jcfg, window=window), 2, 6, slots)
    got = _twin("serve_decode").demo(
        arch, "cpu", window=window, slots=slots, batch=2, steps=6,
        params=module.params_from_jax(tree, get_config(arch, smoke=True), device="cpu"))
    assert got.tolist() == np.asarray(want).tolist()


def test_serve_decode_board():
    """The whole board: four families, the window-8 ring and the decode
    gateway (a mid-flight join)."""
    out = _twin("serve_decode").main(["--device", "cpu", "--batch", "2", "--steps", "4"])
    assert set(out) == {"yi-6b", "rwkv6-7b", "zamba2-2.7b", "qwen3-moe-30b-a3b",
                        "yi-6b window=8", "gateway"}
    assert all(out[k].shape == (2, 4) for k in out if k != "gateway")
    metas = out["gateway"]["metas"]
    assert [m["new_tokens"] for m in metas] == [12, 4, 8]
    assert out["gateway"]["stats"]["joins"] >= 1 and max(m["join_step"] for m in metas) > 0


def test_train_flow_lm_runs_end_to_end():
    """2 CFM steps with checkpoints, RK45 pairs, 4 distillation iterations,
    the artifact's save and load, and a served batch."""
    out = _twin("train_flow_lm").main(["--device", "cpu", "--steps", "2", "--iterations", "4",
                                       "--pairs", "4"])
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
    assert out["latents"] == (4, 16, get_config("yi-6b", smoke=True).latent_dim)
    assert out["tokens"] == (4, 16)
    assert np.isfinite(out["bns_psnr"]) and out["bns_psnr"] >= out["euler_psnr"] - 1e-6


def test_for_device_widens_the_smoke_heads_on_the_card_only():
    """The card's flash kernel takes head dims 64, 80 and 128: the twins'
    smoke models widen their 32-wide heads to 64 there, and nothing else
    changes (the CPU, the full configs, the attention-free rwkv6). The
    widened model runs the flow path."""
    from repro_torch.configs import for_device
    from repro_torch.models import model as M

    smoke = get_config("yi-6b", smoke=True)
    assert for_device(smoke, "cpu") is smoke
    wide = for_device(smoke, "cuda")
    assert wide.resolved_head_dim == 64 and wide.d_model == smoke.d_model
    for arch in ("rwkv6-7b",):
        assert for_device(get_config(arch, smoke=True), "cuda") == get_config(arch, smoke=True)
    for arch in ("yi-6b", "zamba2-2.7b", "whisper-medium"):
        assert for_device(get_config(arch), "cuda") == get_config(arch)
    params = M.init_params(torch.Generator().manual_seed(0), wide, "cpu")
    v = M.velocity(params, wide, torch.tensor(0.5), torch.zeros((2, 8, wide.latent_dim)),
                   {"tokens": torch.zeros((2, 8), dtype=torch.long)})
    assert v.shape == (2, 8, wide.latent_dim) and bool(torch.isfinite(v).all())
