"""The port's flow serving slice against the JAX reference, on the CPU:
``FlowSampler``, the synthetic tokens, latent decoding and the launcher
(solver artifacts distilled, saved and reloaded, anytime budgets, artifacts
the reference's launcher wrote).

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
                          solver=treg.build_ns(name, 4, None))
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
                          solver=treg.build_ns("euler", 2, None))
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


@pytest.mark.parametrize("extra", [
    ["--arch", "rwkv6-7b", "--device", "cuda", "--bns-iters", "300"],
    ["--arch", "rwkv6-7b", "--device", "cuda"],                          # default 300
])
def test_serve_takes_rwkv6_distillation_on_the_card(extra):
    """Distillation of rwkv6-7b on the card runs through gla_scan's backward
    kernel, so the launcher refuses nothing for it: without a card it exits
    for the device alone."""
    _skip_with_a_card()
    with pytest.raises(SystemExit) as exc:
        serve.main(["--arch", "yi-6b", "--device", "cpu"] + extra)
    assert "CUDA" in str(exc.value.code) and "Queue B" not in str(exc.value.code)


@pytest.mark.parametrize("mode", ["flow", "decode"])
@pytest.mark.parametrize("arch", ["whisper-medium", "internvl2-26b"])
def test_serve_serves_whisper_and_internvl2_on_the_cpu(arch, mode):
    """The last two reference archs serve through the launcher in either
    mode (smoke configs): flow requests condition on the batch's frames or
    patches, decode runs the greedy demo."""
    served = serve.main(["--arch", arch, "--mode", mode, "--device", "cpu",
                         "--bns-iters", "0", "--nfe", "2", "--batch", "2", "--seq", "6",
                         "--requests", "2", "--steps", "3"])
    if mode == "flow":
        assert len(served) == 2 and all(s.latents.shape == (2, 6, 64) for s in served)
        assert all(bool(torch.isfinite(s.latents).all()) for s in served)
    else:
        assert served.tokens.shape == (2, 3)


def test_serve_cli_whisper_exits_0_with_no_traceback():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                           "--arch", "whisper-medium", "--smoke", "--device", "cpu",
                           "--bns-iters", "0", "--nfe", "2", "--batch", "2", "--seq", "4",
                           "--requests", "1"], env=env,
                          cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "request 0: sampled (2, 4)" in proc.stdout
    assert "Traceback" not in proc.stderr


def test_every_reference_arch_is_served_or_refused():
    """The port's registry is the reference's (its refusal list is empty);
    an unknown name exits listing the served archs."""
    from repro.configs import ARCHS as JAX_ARCHS
    from repro_torch.configs import ARCHS, UNPORTED_ARCHS

    assert sorted(ARCHS + UNPORTED_ARCHS) == sorted(JAX_ARCHS)
    assert not set(ARCHS) & set(UNPORTED_ARCHS)
    with pytest.raises(SystemExit) as exc:
        serve.main(["--arch", "no-such-arch", "--device", "cpu"])
    assert "qwen3-moe-30b-a3b" in str(exc.value.code)
    help_text = next(a.help for a in serve.build_parser()._actions if a.dest == "arch")
    assert all(arch in help_text for arch in ARCHS) and len(ARCHS) == 10
    assert UNPORTED_ARCHS == ()


_DECODE = ["--arch", "yi-6b", "--mode", "decode", "--device", "cpu"]


def test_serve_decode_gateway_paged_kernel_on_cpu(capsys):
    """The decode gateway through the paged-attention path (its plain version
    on the CPU): every request finishes at its length with in-vocabulary
    tokens, nothing fails, every page returns to the pool, and the gateway's
    counts are the reference launcher's for the same flags (3 two-token
    prompts on 2 slots: 2 prefill calls, 6 decode steps)."""
    from repro_torch.kernels.flash_attention import paged_attention as pa_mod

    before = pa_mod.COUNTER.launches
    served = serve.main(_DECODE + ["--gateway", "--page-size", "4", "--paged-kernel",
                                   "--max-slots", "2", "--slots", "16", "--requests", "3",
                                   "--decode-lengths", "4,2", "--prefill-chunk", "4"])
    assert pa_mod.COUNTER.launches == before
    assert [r.meta["new_tokens"] for r in served.responses] == [4, 2, 4]
    for r in served.responses:
        assert r.meta["finish_reason"] == "length"
        assert all(0 <= t < 256 for t in r.tokens.tolist())
    s = served.stats
    assert (s["completed"], s["failed"], s["pages_in_use"], s["tokens_out"]) == (3, 0, 0, 10)
    assert (s["prefill_calls"], s["batches"], s["forwards"]) == (2, 6, 8)
    assert served.metrics["device_dispatch_ms"]["count"] == 8
    out = capsys.readouterr().out
    assert "request 2: 4 tokens (length)" in out and "paged page_size=4" in out


def test_serve_decode_greedy_demo_on_cpu(capsys):
    """Decode mode without --gateway: the dense greedy demo."""
    served = serve.main(_DECODE + ["--batch", "2", "--steps", "5", "--slots", "16"])
    assert served.tokens.shape == (2, 5) and served.tokens.dtype == torch.int32
    assert served.ms_per_token > 0
    assert "decoded 5 tokens x 2 seqs" in capsys.readouterr().out


def test_serve_decode_sampled_streamed_under_slo(capsys):
    served = serve.main(_DECODE + ["--gateway", "--max-slots", "2", "--slots", "16",
                                   "--requests", "2", "--decode-lengths", "3",
                                   "--temperature", "0.8", "--top-k", "5", "--stream",
                                   "--slo", "--deadline-ms", "1e6", "--priority", "1"])
    assert [r.meta["new_tokens"] for r in served.responses] == [3, 3]
    assert served.stats["goodput"] == 2
    assert capsys.readouterr().out.count("3 streamed tokens") == 2


_FLOW = ["--arch", "yi-6b", "--mode", "flow", "--batch", "2", "--seq", "8", "--device", "cpu"]


@pytest.fixture(autouse=False)
def one_thread():
    """Distillation runs thousands of tiny eager ops: one intra-op thread
    beside the other test workers (as the distillation test files do)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def distilled(tmp_path_factory):
    """One launcher run that distils an NFE-4 BNS solver into an artifact,
    and what it printed."""
    import contextlib
    import io

    path = str(tmp_path_factory.mktemp("artifact") / "bns.msgpack")
    out = io.StringIO()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with contextlib.redirect_stdout(out):
            served = serve.main(_FLOW + ["--nfe", "4", "--bns-iters", "5", "--requests", "2",
                                         "--solver-artifact", path])
    finally:
        torch.set_num_threads(n)
    return path, served, out.getvalue()


def test_serve_distils_saves_the_artifact_and_serves_the_reloaded_copy(distilled):
    from repro_torch.solvers import SolverArtifact, SolverSpec

    path, served, out = distilled
    assert f"solver artifact saved to {path}" in out
    assert "zoo stats: hits=0 misses=1 loads=0 distills=1" in out
    assert (served.zoo.distills, served.zoo.loads) == (1, 0)
    assert (served.artifact.kind, served.artifact.budgets) == ("bns", (4,))
    for a, b in zip(served.artifact.params, served.distillation.params):
        assert torch.equal(a, b)                      # the saved copy is the distilled one
    assert len(served.distillation.iteration_seconds) == 5
    assert all(t > 0 for t in served.distillation.iteration_seconds)
    art = SolverArtifact.load(path)
    assert art.spec == SolverSpec("euler", 4, mode="bns")
    assert art.provenance == {"arch": "yi-6b", "scheduler": "fm_ot", "seed": 0,
                              "bns_iters": 5}
    assert art.val_psnr == served.distillation.val_psnr
    for a, b in zip(served.sampler.solver, art.ns_params):
        assert torch.equal(a, b)                      # the reloaded copy is served


def test_serve_second_run_loads_the_artifact_with_no_retraining(distilled, capsys, one_thread):
    """The same flags again: the artifact is loaded (a zoo load, no
    distillation) and the requests' latents equal the first run's, to the bit."""
    path, first, _ = distilled
    served = serve.main(_FLOW + ["--nfe", "4", "--bns-iters", "5", "--requests", "2",
                                 "--solver-artifact", path])
    out = capsys.readouterr().out
    assert "(no retraining)" in out and "distilling" not in out
    assert "zoo stats: hits=0 misses=1 loads=1 distills=0" in out
    assert served.distillation is None and served.zoo.loads == 1
    for a, b in zip(served.sampler.solver, first.sampler.solver):
        assert torch.equal(a, b)
    for a, b in zip(served, first):
        assert torch.equal(a.latents, b.latents) and torch.equal(a.tokens, b.tokens)


def test_serve_anytime_budgets_route_requests_and_warn_once(tmp_path, capsys, one_thread):
    path = str(tmp_path / "any.msgpack")
    served = serve.main(_FLOW + ["--budgets", "2,4", "--request-budgets", "2,4,8",
                                 "--requests", "6", "--bns-iters", "3",
                                 "--solver-artifact", path])
    out = capsys.readouterr().out
    assert "distilling anytime solver (budgets=(2, 4))" in out
    assert out.count("WARNING: requested NFE 8 not served by the artifact (budgets (2, 4)); "
                     "using nearest budget 4") == 1
    assert [s.nfe for s in served] == [2, 4, 4, 2, 4, 4]
    assert (served.artifact.kind, served.artifact.budgets) == ("anytime", (2, 4))
    assert served.zoo.distills == 1
    assert isinstance(served.sampler, serve.AnytimeFlowSampler)
    again = serve.main(_FLOW + ["--budgets", "2,4", "--request-budgets", "2,4", "--requests",
                                "2", "--solver-artifact", path])
    assert "(no retraining)" in capsys.readouterr().out
    for a, b in zip(again, served):
        assert torch.equal(a.latents, b.latents)


def test_serve_strict_nfe_exits_nonzero(tmp_path, one_thread):
    path = str(tmp_path / "any.msgpack")
    serve.main(_FLOW + ["--budgets", "2,4", "--requests", "1", "--bns-iters", "2",
                        "--solver-artifact", path])
    with pytest.raises(SystemExit) as exc:
        serve.main(_FLOW + ["--budgets", "2,4", "--request-budgets", "2,8", "--requests", "2",
                            "--strict-nfe", "--solver-artifact", path])
    assert exc.value.code not in (0, None) and "--strict-nfe" in str(exc.value.code)
    with pytest.raises(SystemExit) as exc:
        serve.main(_FLOW + ["--nfe", "8", "--strict-nfe", "--requests", "1",
                            "--bns-iters", "0", "--solver-artifact", path])
    assert "serves (2, 4)" in str(exc.value.code)


def test_serve_initial_anytime_solver_without_distillation(capsys):
    served = serve.main(_FLOW + ["--budgets", "2,4", "--requests", "2", "--bns-iters", "0"])
    out = capsys.readouterr().out
    assert "serving the initial anytime solver at budgets (2, 4) (no distillation)" in out
    assert [s.nfe for s in served] == [2, 4] and served.distillation is None
    assert "distilling" not in out and served.zoo.distills == 0


def test_serve_loads_an_artifact_the_reference_launcher_wrote(tmp_path, capsys, one_thread):
    """``repro.launch.serve`` distils and saves; the port's launcher serves
    that file with no retraining, its solver bit-equal to the file's."""
    from repro.launch import serve as jserve
    from repro.solvers import SolverArtifact as JaxArtifact

    path = str(tmp_path / "ref.msgpack")
    jserve.serve_flow(jserve.build_parser().parse_args(
        ["--arch", "yi-6b", "--mode", "flow", "--nfe", "2", "--batch", "2", "--seq", "8",
         "--bns-iters", "2", "--requests", "1", "--solver-artifact", path]))
    assert f"solver artifact saved to {path}" in capsys.readouterr().out
    served = serve.main(_FLOW + ["--nfe", "2", "--requests", "1", "--solver-artifact", path])
    out = capsys.readouterr().out
    assert "loaded solver artifact" in out and "(no retraining)" in out
    assert "WARNING" not in out and served.zoo.distills == 0 and served.zoo.loads == 1
    want = JaxArtifact.load(path).ns_params
    for a, b in zip(served.sampler.solver, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert served[0].latents.shape == (2, 8, 64) and bool(torch.isfinite(served[0].latents).all())


def test_serve_zoo_dir_written_by_the_reference(tmp_path, capsys):
    """--zoo-dir indexes a directory the reference's SolverZoo saved into:
    the requested spec loads from it, no distillation."""
    from repro.core import ns_solver as jns
    from repro.serving import SolverZoo as JaxZoo
    from repro.solvers import SolverArtifact as JaxArtifact
    from repro.solvers import SolverSpec as JaxSpec

    spec = JaxSpec("euler", 4, mode="bns")
    JaxZoo(save_dir=str(tmp_path), distill_fn=lambda s: JaxArtifact(
        spec=s, params=jns.from_ns(jreg.build_ns("euler", 4, None)), val_psnr=1.0)).get(spec)
    served = serve.main(_FLOW + ["--nfe", "4", "--requests", "1", "--zoo-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "zoo: loaded bns/euler from" in out and "distilling" not in out
    assert (served.zoo.loads, served.zoo.distills, served.artifact.kind) == (1, 0, "bns")


# ---------------------------------------------------------------------------
# The reference's flags, and baselines served from artifacts
# ---------------------------------------------------------------------------


def _option_strings(parser) -> set:
    return {s for a in parser._actions for s in a.option_strings}


def test_reference_flags_are_a_subset_of_the_ports():
    """Every option string of ``repro.launch.serve``'s parser parses in the
    port's (both parsers load on the CPU)."""
    from repro.launch import serve as jserve

    ref, port = _option_strings(jserve.build_parser()), _option_strings(serve.build_parser())
    assert ref <= port, sorted(ref - port)
    ref_args = vars(jserve.build_parser().parse_args(["--arch", "yi-6b"]))
    port_args = vars(serve.build_parser().parse_args(["--arch", "yi-6b"]))
    for dest in ("ckpt", "continuous", "fleet", "kernel_update", "max_batch", "max_wait_ms",
                 "mesh", "mixed_budget_policy", "profile", "tiers"):
        assert port_args[dest] == ref_args[dest], dest


def _trained_checkpoint(tmp_path, seed=5):
    """yi-6b smoke weights other than the launcher's seed-0 draw, trained two
    steps by the port's trainer and saved at its last step."""
    from repro_torch.launch import train

    ckpt_dir = str(tmp_path / "ckpt")
    run = train.main(["--arch", "yi-6b", "--smoke", "--steps", "2", "--batch", "2",
                      "--seq", "8", "--seed", str(seed), "--device", "cpu",
                      "--ckpt-dir", ckpt_dir, "--ckpt-every", "2"])
    return os.path.join(ckpt_dir, "step_2.msgpack"), run.params


def test_serve_ckpt_flow_serves_the_restored_params(tmp_path, capsys):
    """``--ckpt`` in flow mode (the reference's ``serve.py:196-198``): every
    request's latents equal, to the bit, a ``FlowSampler`` on the trainer's
    params with the launcher's conditioning and noise seeds."""
    path, params = _trained_checkpoint(tmp_path)
    served = serve.main(_FLOW + ["--nfe", "2", "--requests", "2", "--bns-iters", "0",
                                 "--ckpt", path])
    assert f"restored params from {path}" in capsys.readouterr().out
    cfg = get_config("yi-6b", smoke=True)
    cond = SyntheticTokens(cfg, DataConfig(batch_size=2, seq_len=8, seed=0),
                           device="cpu").batch(0)
    sampler = FlowSampler(params=params, cfg=cfg, sched=tsched.fm_ot(),
                          solver=treg.build_ns("euler", 2, None))
    for req, s in enumerate(served):
        want = sampler.sample(cond, torch.Generator().manual_seed(1000 + req))
        assert torch.equal(s.latents, want)
    unrestored = serve.main(_FLOW + ["--nfe", "2", "--requests", "1", "--bns-iters", "0"])
    assert not torch.equal(unrestored[0].latents, served[0].latents)


def test_serve_ckpt_decode_serves_the_restored_params(tmp_path, capsys):
    """``--ckpt`` in decode mode (the reference's ``serve.py:363-364``): the
    greedy demo's tokens equal ``greedy_demo`` on the trainer's params."""
    from repro_torch.serving.engine import DecodeEngine, greedy_demo

    path, params = _trained_checkpoint(tmp_path)
    served = serve.main(_DECODE + ["--batch", "2", "--steps", "6", "--slots", "16",
                                   "--ckpt", path])
    assert f"restored params from {path}" in capsys.readouterr().out
    engine = DecodeEngine(params=params, cfg=get_config("yi-6b", smoke=True))
    want, _ = greedy_demo(engine, 2, 6, 16)
    assert torch.equal(served.tokens, want)


def test_serve_ckpt_restores_a_reference_checkpoint(tmp_path):
    """A checkpoint the reference's trainer's checkpointer wrote serves in the
    port's launcher as the reference's weights: the latents equal a sampler
    on ``params_from_jax`` of them."""
    from repro.checkpoint import checkpointer as jckpt

    jcfg = jax_get_config("yi-6b", smoke=True)
    jparams = jmodel.init_params(jax.random.PRNGKey(9), jcfg)
    path = str(tmp_path / "step_1.msgpack")
    jckpt.save(path, jparams)
    served = serve.main(_FLOW + ["--nfe", "2", "--requests", "1", "--bns-iters", "0",
                                 "--ckpt", path])
    cfg = get_config("yi-6b", smoke=True)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    cond = SyntheticTokens(cfg, DataConfig(batch_size=2, seq_len=8, seed=0),
                           device="cpu").batch(0)
    want = FlowSampler(params=params, cfg=cfg, sched=tsched.fm_ot(),
                       solver=treg.build_ns("euler", 2, None)
                       ).sample(cond, torch.Generator().manual_seed(1000))
    assert torch.equal(served[0].latents, want)


@pytest.mark.parametrize("mode", ["flow", "decode"])
def test_serve_ckpt_draws_no_random_weights(mode, tmp_path, monkeypatch):
    """With ``--ckpt`` the launcher restores into ``param_template`` and
    never draws the random weights it would replace (the weights are on the
    device once); flow serves the checkpoint's params, each leaf a real
    tensor."""
    from torch._subclasses.fake_tensor import FakeTensor

    from repro_torch.models import model as M
    from repro_torch.optim.adam import tree_leaves

    path, params = _trained_checkpoint(tmp_path)

    init_params = M.init_params

    def drawn(*args):
        tree = init_params(*args)
        assert all(isinstance(x, FakeTensor) for x in tree_leaves(tree)), \
            "random weights drawn under --ckpt"
        return tree

    monkeypatch.setattr(serve.M, "init_params", drawn)
    if mode == "decode":
        served = serve.main(_DECODE + ["--batch", "2", "--steps", "2", "--slots", "8",
                                       "--ckpt", path])
        assert served.tokens.shape[0] == 2
        return
    served = serve.main(_FLOW + ["--nfe", "2", "--requests", "1", "--bns-iters", "0",
                                 "--ckpt", path])
    assert bool(torch.isfinite(served[0].latents).all())
    for a, b in zip(tree_leaves(served.sampler.params), tree_leaves(params)):
        assert type(a) is torch.Tensor and torch.equal(a, b)


@pytest.mark.parametrize("extra,done,fleet", [
    (["--mesh", "host", "--request-budgets", "2", "--requests", "2"], 2, False),
    (["--fleet", "2", "--request-budgets", "2,4", "--requests", "4"], 4, True),
])
def test_serve_fleet_and_mesh_host_serve_on_the_cpu(extra, done, fleet, capsys):
    """``tests/test_serve_cli.py``'s mesh-host and fleet cases: the flow
    gateway on the 1 x 1 host mesh (a gloo group of one on the CPU), and a
    two-host ``FleetGateway``; every request completes and the fleet's
    summary carries its routing."""
    served = serve.main(_FLOW + ["--seq", "4", "--budgets", "2,4", "--bns-iters", "0",
                                 "--gateway", "--max-batch", "2", "--max-wait-ms", "50"]
                        + extra)
    out = capsys.readouterr().out
    assert f"gateway stats: done={done}/{done}" in out
    assert all(r is not None for r in served.responses)
    assert ("fleet hosts=2" in out and "routed:" in out) == fleet
    if fleet:
        assert sum(served.stats["routed"].values()) == done


def test_serve_reference_flags_at_their_defaults_change_nothing(capsys):
    """The reference's flags given at their defaults serve as without them
    (``--profile default`` re-executes nothing)."""
    served = serve.main(_FLOW + ["--nfe", "2", "--requests", "1", "--bns-iters", "0",
                                 "--max-batch", "8", "--max-wait-ms", "10", "--mesh", "none",
                                 "--fleet", "1", "--mixed-budget-policy", "auto",
                                 "--profile", "default"])
    assert len(served) == 1 and "not served" not in capsys.readouterr().out


def test_serve_kernel_update_is_an_accepted_no_op(capsys):
    served = serve.main(_FLOW + ["--nfe", "2", "--requests", "1", "--bns-iters", "0",
                                 "--kernel-update"])
    out = capsys.readouterr().out
    assert out.count("--kernel-update: a no-op") == 1 and "ns_update kernel" in out
    assert len(served) == 1 and bool(torch.isfinite(served[0].latents).all())


def test_serve_a_dpm2m_baseline_artifact_the_reference_wrote(setup, tmp_path, capsys,
                                                              monkeypatch):
    """A dpm2m baseline written by the reference's SolverArtifact serves in
    the port's launcher through FlowSampler.from_artifact, no retraining,
    its NSParams bit-equal to the file's; on the reference's weights and one
    shared x0 the served session's latents are the reference's."""
    from repro.solvers import SolverArtifact as JaxArtifact
    from repro.solvers import SolverSpec as JaxSpec

    jcfg, jparams, cfg, params, _ = setup
    jspec = JaxSpec("dpm2m", 4)
    jfield = jmodel.velocity_field(jparams, jcfg, jsched.fm_ot())
    path = str(tmp_path / "dpm2m.msgpack")
    JaxArtifact(spec=jspec, params=jspec.build(jfield), val_psnr=0.0,
                provenance={"arch": "yi-6b", "scheduler": "fm_ot"}).save(path)
    monkeypatch.setattr(serve.M, "init_params", lambda generator, cfg_, device: params)
    served = serve.main(_FLOW + ["--nfe", "4", "--requests", "1", "--solver-artifact", path])
    out = capsys.readouterr().out
    assert "loaded solver artifact" in out and "baseline/dpm2m" in out
    assert "WARNING" not in out and (served.zoo.loads, served.zoo.distills) == (1, 0)
    ref = JaxArtifact.load(path)
    for a, b in zip(served.sampler.solver, ref.ns_params):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    tok = np.array(JaxSyntheticTokens(jcfg, JaxDataConfig(batch_size=2, seq_len=8, seed=0))
                   .batch(0)["tokens"])
    x0 = np.random.default_rng(21).standard_normal((2, 8, cfg.latent_dim)).astype(np.float32)
    want = JaxFlowSampler.from_artifact(ref, params=jparams, cfg=jcfg, sched=jsched.fm_ot()
                                        ).sample_from({"tokens": jnp.asarray(tok)},
                                                      jnp.asarray(x0))
    got = served.sampler.sample_from({"tokens": torch.from_numpy(tok)}, x0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL * 4, rtol=TOL * 4)
    assert served[0].nfe == 4 and bool(torch.isfinite(served[0].latents).all())


# ---------------------------------------------------------------------------
# The flow gateways through the launcher (tests/test_serve_cli.py's gateway
# cases, in process on the CPU), and the telemetry flags of both gateways
# ---------------------------------------------------------------------------

_ANYTIME = _FLOW[:-4] + ["--seq", "4", "--device", "cpu", "--budgets", "2,4",
                         "--bns-iters", "0"]


def test_serve_flow_gateway_coalesces_requests(capsys):
    """Same-budget requests coalesce (4 requests -> 2 full batches) and the
    summary reports the batches (``test_serve_cli.py:77``)."""
    served = serve.main(_ANYTIME + ["--gateway", "--max-batch", "2", "--max-wait-ms", "200",
                                    "--request-budgets", "2,4,2,4", "--requests", "4"])
    out = capsys.readouterr().out
    assert "gateway stats: done=4/4" in out and "batches=2" in out
    assert "request 0: served 2 NFE" in out and "request 1: served 4 NFE" in out
    assert "batch 2/2" in out
    assert isinstance(served, serve.GatewayServed) and served.stats["failed"] == 0
    assert [r.meta["served_budget"] for r in served.responses] == [2, 4, 2, 4]
    for r in served.responses:
        assert isinstance(r.latents, np.ndarray) and r.latents.shape == (4, 64)
    assert served.zoo.distills == 0 and served.artifact.kind == "anytime"


def test_serve_flow_gateway_records_budget_drift(capsys):
    """An unserved budget is routed AND the (requested, served) pair is
    printed per request (``test_serve_cli.py:95``)."""
    serve.main(_ANYTIME + ["--gateway", "--max-batch", "2", "--max-wait-ms", "50",
                           "--request-budgets", "8", "--requests", "2"])
    assert capsys.readouterr().out.count("served 4 NFE (requested 8)") == 2


def test_serve_flow_gateway_strict_nfe_exits():
    with pytest.raises(SystemExit) as exc:
        serve.main(_ANYTIME + ["--gateway", "--strict-nfe", "--request-budgets", "8",
                               "--requests", "1"])
    assert "--strict-nfe" in str(exc.value.code)


def test_serve_flow_continuous_gateway(capsys):
    """``--continuous`` serves through trajectories; the summary reports
    trajectories, joins and slot occupancy (``test_serve_cli.py:134``)."""
    served = serve.main(_ANYTIME + ["--gateway", "--continuous", "--max-slots", "2",
                                    "--max-wait-ms", "50", "--request-budgets", "2,4",
                                    "--requests", "4"])
    out = capsys.readouterr().out
    assert "gateway stats: done=4/4" in out and "traj=" in out and "slot_occ=" in out
    assert served.stats["trajectories"] >= 1
    assert all(r.meta["continuous"] for r in served.responses if "continuous" in r.meta)


def test_serve_flow_continuous_needs_an_anytime_solver():
    with pytest.raises(SystemExit) as exc:
        serve.main(_FLOW + ["--nfe", "2", "--bns-iters", "0", "--gateway", "--continuous",
                            "--requests", "1"])
    assert "--continuous" in str(exc.value.code) and "carry" in str(exc.value.code)


def test_serve_flow_gateway_mixed_budget_policy_never(capsys):
    served = serve.main(_ANYTIME + ["--gateway", "--max-batch", "4",
                                    "--mixed-budget-policy", "never",
                                    "--request-budgets", "2,4", "--requests", "2"])
    assert (served.stats["batches"], served.stats["mixed_batches"]) == (2, 0)
    assert served.stats["forwards"] == 6


def test_serve_flow_gateway_tiers_crop_to_the_native_shape():
    """``--tiers 8`` pads 6-position requests to 8 and crops back: each row
    equals the direct sampler on that request alone at its native shape
    (yi-6b's field is causal), its noise drawn from seed 1000 + req."""
    from repro_torch.serving.gateway import request_noise

    served = serve.main(_FLOW[:-4] + ["--seq", "6", "--device", "cpu", "--budgets", "2,4",
                                      "--bns-iters", "0", "--gateway", "--tiers", "8",
                                      "--max-batch", "2", "--request-budgets", "4",
                                      "--requests", "2"])
    tokens = SyntheticTokens(served.sampler.cfg, DataConfig(batch_size=2, seq_len=6, seed=0),
                             device="cpu").batch(0)
    for req, r in enumerate(served.responses):
        assert r.meta["tier_shape"] == (8, 64) and r.latents.shape == (6, 64)
        x0 = request_noise(6, 64, 1000 + req)
        direct = served.sampler.sample_from({"tokens": tokens["tokens"][req:req + 1]},
                                            x0[None], 4)
        np.testing.assert_array_equal(r.latents, direct[0].numpy())
    assert served.metrics['tier_occupancy{tier="8x64"}'] == pytest.approx(12 / 16)


def test_serve_flow_gateway_tiers_reject_oversize():
    with pytest.raises(SystemExit) as exc:
        serve.main(_ANYTIME + ["--gateway", "--tiers", "2", "--requests", "1"])
    assert "--tiers" in str(exc.value.code) and "4 positions" in str(exc.value.code)


@pytest.mark.parametrize("deadline,cost,want", [("1e6", "0", "goodput"),
                                                ("1", "1e9", "rejected")])
def test_serve_flow_gateway_slo_deadlines(capsys, deadline, cost, want):
    served = serve.main(_ANYTIME + ["--gateway", "--slo", "--deadline-ms", deadline,
                                    "--slo-default-cost-ms", cost, "--priority", "1",
                                    "--request-budgets", "2,4", "--requests", "2"])
    assert served.stats[want] == 2
    if want == "rejected":
        assert served.responses == [None, None]
        assert capsys.readouterr().out.count("REJECTED at admission") == 2


def test_serve_flow_gateway_streams_exit_partials(capsys):
    """``--continuous --stream``: a budget-4 request crosses the budget-2
    exit on the way (one partial), a budget-2 request none."""
    served = serve.main(_ANYTIME + ["--gateway", "--continuous", "--max-slots", "2",
                                    "--stream", "--request-budgets", "2,4",
                                    "--requests", "2"])
    assert served.partials == [0, 1]
    assert "1 streamed partials" in capsys.readouterr().out


class _ScrapedServer(serve.MetricsServer):
    """The launcher's metrics server, scraped over localhost before it
    stops (while the gateway's registry is live)."""

    bodies: list = []

    def stop(self):
        import urllib.request

        for path in ("/metrics", "/metrics.json"):
            with urllib.request.urlopen(f"http://127.0.0.1:{self.port}{path}",
                                        timeout=10) as resp:
                _ScrapedServer.bodies.append(resp.read().decode())
        super().stop()


class _FlushingPrinter(serve.StatsPrinter):
    """The launcher's stats printer, made to print one line as it stops, so
    a short CPU run shows the periodic line deterministically."""

    def stop(self):
        super().stop()
        self.log("periodic " + self.line_fn())


@pytest.mark.parametrize("mode", ["flow", "decode"])
@pytest.mark.parametrize("flag", ["--metrics-json", "--trace-jsonl", "--metrics-port",
                                  "--stats-interval"])
def test_serve_gateway_telemetry_flags(tmp_path, capsys, monkeypatch, mode, flag):
    import json

    from repro_torch.observability import read_jsonl

    argv = (_ANYTIME + ["--gateway", "--requests", "2", "--request-budgets", "2,4"]
            if mode == "flow" else
            _DECODE + ["--gateway", "--max-slots", "2", "--slots", "16", "--requests", "2",
                       "--decode-lengths", "2"])
    path = str(tmp_path / "out")
    value = {"--metrics-json": path, "--trace-jsonl": path, "--metrics-port": "0",
             "--stats-interval": "30"}[flag]
    monkeypatch.setattr(serve, "MetricsServer", _ScrapedServer)
    monkeypatch.setattr(serve, "StatsPrinter", _FlushingPrinter)
    _ScrapedServer.bodies = []
    served = serve.main(argv + [flag, value])
    out = capsys.readouterr().out
    assert served.stats["completed"] == 2
    prefix = "gateway stats" if mode == "flow" else "decode gateway stats"
    if flag == "--metrics-json":
        with open(path) as fh:
            snap = json.load(fh)
        assert snap["completed"] == 2 and f"metrics snapshot written to {path}" in out
    elif flag == "--trace-jsonl":
        events = read_jsonl(path)
        assert {e["event"] for e in events} >= {"submit", "settle"}
        assert f"events written to {path}" in out
    elif flag == "--metrics-port":
        assert "metrics: http://127.0.0.1:" in out
        prom, js = _ScrapedServer.bodies
        assert "completed" in prom and json.loads(js)["submitted"] == 2
    else:
        assert f"periodic {prefix}: done=" in out
