"""The production-mesh dry run (``repro_torch.launch.dryrun``) and its cost
counter (``repro_torch.analysis.counter``) against the reference's
``repro.launch.dryrun`` and ``repro.analysis.hlo``.

The dry run starts a fake process group of 256 or 512 ranks, which must not
meet the gloo group of one rank other test files start in the same worker:
every case that needs a world runs in a subprocess of its own (this file
run as a script, ``python tests/test_torch_dryrun.py CASE OUT``, writing
JSON to OUT), under a timeout. The reference's side runs here, on abstract
meshes and one CPU device.

  bytes     every arch's per-rank argument bytes on both production meshes,
            for its params and for decode_32k's state, equal to
            sum(numel * itemsize / the product of the split axes' sizes)
            from the reference's specs (``jax.eval_shape`` and
            ``sharding.param_specs`` / ``state_specs`` on ``AbstractMesh``).
  counter   the counter on known layouts: a (65536, 4096) x (4096, 14336)
            product on the 16 x 16 mesh counts one rank's share, 2 * 4096 *
            4096 * 896 flops, not the global 7.7e12; a redistribution counts
            its all-gather's bytes; DTensor's own shape propagation counts
            nothing.
  smoke     the smoke configs through ``run_combo`` on the fake 16 x 16
            mesh, all four shapes (their kinds and batches; prefill and train
            at SMOKE_SEQ positions, where the plain chunked scans at 32k cost
            minutes on the CPU), ``--device cpu``: every combo ``ok``, and the
            record's keys the reference's (less its compiler's: ``compile_s``,
            ``flops_raw``, ``bytes_raw`` and the generated code's bytes; plus
            the peak and the hand-written kernels' fake launches).
  flops     each family's smoke config on a 1 x 1 fake world
            (``reckon_host``): prefill and decode flops against the
            reference's ``hlo.analyze`` of the compiled step within
            FLOPS_RTOL, and train (``test_train_flops_...``).
  routing   the kernel entries on a fake 2 x 2 mesh on the card's device
            type: DTensors reach the flash and gla_scan launchers as fake
            local shards, which allocate and launch nothing, with the build
            made to raise.

On a card the same smoke run on ``--device cuda`` is
``tests/test_torch_cuda.py::test_dryrun_smoke_configs_on_the_cards_paths``
(that file imports no JAX); a CPU-only torch cannot take a fake CUDA tensor
through Python indexing or autograd.
"""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.analysis import hlo
from repro.configs import get_config as jax_get_config
from repro.core.schedulers import get_scheduler as jax_scheduler
from repro.distributed import sharding as jsharding
from repro.models import model as jmodel
from repro.optim import adam_init as jax_adam_init
from repro.optim import adam_update as jax_adam_update
from repro_torch.configs import ARCHS

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"pod16x16": {"data": 16, "model": 16},
          "pod2x16x16": {"pod": 2, "data": 16, "model": 16}}
SMOKE_SEQ = 128
FLOPS_RTOL = 0.02
FAMILY_ARCHS = ("yi-6b", "qwen3-moe-30b-a3b", "rwkv6-7b", "zamba2-2.7b", "whisper-medium",
                "internvl2-26b")
FLOP_SHAPES = {"prefill": dict(kind="prefill", batch=2, seq=64),
               "decode": dict(kind="decode", batch=2, seq=64),
               "train": dict(kind="train", batch=2, seq=64)}


@pytest.fixture(scope="module")
def world_results(tmp_path_factory):
    """Every subprocess case, started together; each under its own timeout."""
    tmp = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    cases = ("bytes", "counter", "smoke0", "smoke1", "flops", "routing")
    procs = {c: subprocess.Popen([sys.executable, __file__, c, str(tmp / f"{c}.json")],
                                 env=env, cwd=ROOT, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True) for c in cases}
    out, logs = {}, {}
    try:
        for c, p in procs.items():
            logs[c] = p.communicate(timeout=600)[0]
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    for c, p in procs.items():
        out[c] = (json.loads((tmp / f"{c}.json").read_text()) if p.returncode == 0
                  else {"error": logs[c][-6000:]})
    for half in ("smoke0", "smoke1"):      # the smoke run, in two processes
        res = out.pop(half)
        out["smoke"] = ({"error": res["error"]} if "error" in res or "error" in out.get(
            "smoke", {}) else {**out.get("smoke", {}), **res})
    return out


def _case(world_results, name):
    res = world_results[name]
    assert "error" not in res, res.get("error")
    return res


# ---------------------------------------------------------------------------
# Bytes against the reference's specs (exact)
# ---------------------------------------------------------------------------


def _abstract_mesh(sizes: dict):
    try:
        return AbstractMesh(tuple(sizes.values()), tuple(sizes))
    except TypeError:   # jax<0.5 signature: AbstractMesh(((name, size), ...))
        return AbstractMesh(tuple(sizes.items()))


def _split_bytes(shapes, specs, sizes: dict) -> int:
    leaves = jax.tree_util.tree_leaves(shapes)
    spec_leaves = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    assert len(leaves) == len(spec_leaves)
    total = 0
    for leaf, spec in zip(leaves, spec_leaves):
        parts = 1
        for entry in spec:
            for axis in ((entry,) if isinstance(entry, str) else (entry or ())):
                parts *= sizes[axis]
        n = int(np.prod(leaf.shape)) * np.dtype(leaf.dtype).itemsize
        assert n % parts == 0, (leaf.shape, spec)
        total += n // parts
    return total


def _ref_bytes(arch: str, sizes: dict) -> dict:
    cfg = jax_get_config(arch)
    mesh = _abstract_mesh(sizes)
    params = jax.eval_shape(
        lambda: jmodel.init_params(jax.random.PRNGKey(0), cfg, dtype=jnp.bfloat16))
    state = jax.eval_shape(lambda: jmodel.init_decode_state(
        cfg, 128, 32768, jnp.bfloat16,
        num_frames=cfg.frontend.num_tokens if cfg.frontend else 1500))
    return {"params": _split_bytes(params, jsharding.param_specs(params, cfg, mesh), sizes),
            "state": _split_bytes(state, jsharding.state_specs(state, cfg, mesh, 128), sizes)}


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_argument_bytes_equal_the_reference_specs(world_results, arch, mesh):
    ours = _case(world_results, "bytes")[mesh][arch]
    assert ours == _ref_bytes(arch, MESHES[mesh])


# ---------------------------------------------------------------------------
# The counter on known layouts
# ---------------------------------------------------------------------------


def test_counter_counts_one_ranks_local_product(world_results):
    res = _case(world_results, "counter")
    assert res["mm_flops"] == 2 * 4096 * 4096 * 896          # 3.0e10, not 7.7e12
    assert res["mm_local_shape"] == [4096, 896]
    assert res["mm_collectives"] == {}


def test_counter_counts_a_redistributions_all_gather(world_results):
    res = _case(world_results, "counter")
    # (65536, 4096) bf16 split 16 ways on its rows, gathered: the output is
    # the whole tensor, once
    assert res["gather_collectives"] == {"all-gather": 65536 * 4096 * 2,
                                         "all-gather_count": 1}
    assert res["gather_flops"] == 0


def test_counter_tracks_live_and_peak_bytes(world_results):
    res = _case(world_results, "counter")
    assert res["mm_peak"] == 4096 * 896 * 2                  # the local output
    assert res["mm_live"] == 4096 * 896 * 2


# ---------------------------------------------------------------------------
# The smoke configs end to end, and the record's keys
# ---------------------------------------------------------------------------


def _reference_record_keys() -> tuple[set, set]:
    """The keys ``repro.launch.dryrun.run_combo`` writes, read off its
    source (no 512-device XLA here): the record's and its memory's."""
    tree = ast.parse((ROOT / "src" / "repro" / "launch" / "dryrun.py").read_text())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == "run_combo")
    keys, memory = set(), set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Dict) and all(isinstance(k, ast.Constant) for k in node.keys):
            keys |= {k.value for k in node.keys}
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "update"):
            keys |= {kw.arg for kw in node.keywords}
            for kw in node.keywords:
                if kw.arg == "memory":
                    memory |= {e.value for e in ast.walk(kw.value)
                               if isinstance(e, ast.Constant) and isinstance(e.value, str)
                               and e.value.endswith("_in_bytes")}
    return keys, memory


def test_reference_keys_are_read_from_its_source():
    keys, memory = _reference_record_keys()
    assert {"arch", "shape", "mesh", "status", "compile_s", "flops", "collectives",
            "memory"} <= keys
    assert memory == {"argument_size_in_bytes", "output_size_in_bytes", "temp_size_in_bytes",
                      "generated_code_size_in_bytes"}


SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_configs_end_to_end_on_the_fake_mesh(world_results, arch, shape):
    rec = _case(world_results, "smoke")[f"{arch}__{shape}"]
    if arch == "whisper-medium" and shape == "long_500k":
        assert rec["status"] == "skipped"
        return
    assert rec["status"] == "ok", rec
    keys, memory = _reference_record_keys()
    # "reason" is a skipped record's
    assert set(rec) == (keys - {"compile_s", "flops_raw", "bytes_raw", "reason"}) | {"kernels"}
    assert set(rec["memory"]) == (memory - {"generated_code_size_in_bytes"}) | {
        "peak_size_in_bytes"}
    mem = rec["memory"]
    assert mem["peak_size_in_bytes"] >= mem["argument_size_in_bytes"] > 0
    assert rec["flops"] > 0 and rec["bytes"] > 0 and rec["devices"] == 256
    assert rec["kernels"] == {}                       # the CPU's plain paths


# ---------------------------------------------------------------------------
# Flops against the reference's HLO analysis
# ---------------------------------------------------------------------------


def _ref_flops(arch: str, kind: str) -> float:
    cfg = jax_get_config(arch, smoke=True)
    info = FLOP_SHAPES[kind]
    B, S = info["batch"], info["seq"]
    params = jax.eval_shape(
        lambda: jmodel.init_params(jax.random.PRNGKey(0), cfg, dtype=jnp.bfloat16))
    sds = jax.ShapeDtypeStruct
    batch = {"tokens": sds((B, S), jnp.int32)}
    if cfg.frontend is not None:
        key = "frames" if cfg.frontend.kind == "audio_frames" else "patches"
        batch[key] = sds((B, cfg.frontend.num_tokens, cfg.frontend.embed_dim), jnp.bfloat16)
    if kind == "prefill":
        fn = jax.jit(lambda p, b: jmodel.lm_apply(p, cfg, b, last_only=True))
        lowered = fn.lower(params, batch)
    elif kind == "decode":
        state = jax.eval_shape(lambda: jmodel.init_decode_state(
            cfg, B, S, jnp.bfloat16,
            num_frames=cfg.frontend.num_tokens if cfg.frontend else 1500))
        fn = jax.jit(lambda p, t, s: jmodel.decode_apply(p, cfg, t, s))
        lowered = fn.lower(params, sds((B,), jnp.int32), state)
    else:
        sched = jax_scheduler("fm_ot")
        opt = jax.eval_shape(jax_adam_init, params)

        def train_step(p, o, b, rng):
            loss, grads = jax.value_and_grad(
                lambda q: jmodel.cfm_loss(q, cfg, b, rng, sched, remat=True))(p)
            return jax_adam_update(grads, o, p, 1e-4) + (loss,)
        lowered = jax.jit(train_step).lower(params, opt, batch, sds((2,), jnp.uint32))
    return hlo.analyze(lowered.compile().as_text())["flops"]


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_flops_agree_with_the_references_hlo_analysis(world_results, arch, kind):
    ours = _case(world_results, "flops")[arch][kind]
    ref = _ref_flops(arch, kind)
    assert ours == pytest.approx(ref, rel=FLOPS_RTOL), (ours, ref)


@pytest.mark.parametrize("arch", ["yi-6b", "qwen3-moe-30b-a3b"])
def test_train_flops_against_the_references(world_results, arch):
    """The train step: the port's remat (``torch.utils.checkpoint`` of each
    layer) recomputes every layer's forward in the backward, as the
    reference's ``jax.checkpoint`` does; the backward's products are
    autograd's and XLA's. Torch's checkpoint replays a layer only up to the
    last op that saves a tensor for the backward, where XLA drops the dead
    products of the replay; so the moe layer forms its aux loss in its one
    router pass, before the expert products. Formed after them, it would
    replay each layer's combine product, 5.4% more flops than the
    reference's at 2 x 64."""
    ours = _case(world_results, "flops")[arch]["train"]
    ref = _ref_flops(arch, "train")
    assert ours == pytest.approx(ref, rel=FLOPS_RTOL), (ours, ref)


# ---------------------------------------------------------------------------
# The launchers on fake tensors: allocations, no launch, no build
# ---------------------------------------------------------------------------


def test_launchers_on_fake_tensors_allocate_and_never_build(monkeypatch):
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.analysis.counter import CostCounter
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.gla_scan import gla_scan as gs

    def refuse(*a, **k):
        raise AssertionError("a build under fake tensors")

    monkeypatch.setattr(build, "load", refuse)
    monkeypatch.setattr(build, "build_all", refuse)
    before = (fa.COUNTER.launches, fa.BWD_COUNTER.launches, gs.COUNTER.launches,
              gs.BWD_COUNTER.launches)
    mode = FakeTensorMode()
    with mode, CostCounter(mode) as c:
        q = torch.empty(2, 4, 64, 128, dtype=torch.bfloat16, device="cuda")
        kv = torch.empty(2, 2, 64, 128, dtype=torch.bfloat16, device="cuda")
        o, lse = fa.flash_attention(q, kv, kv, causal=True, return_lse=True)
        assert o.shape == q.shape and lse.shape == (2, 4, 64) and o.is_cuda
        dq, dk, dv = fa.flash_attention_bwd(q, kv, kv, o, lse, o, causal=True)
        assert dq.shape == q.shape and dk.shape == kv.shape
        g = torch.empty(2, 40, 3, 64, dtype=torch.bfloat16, device="cuda")
        ld = torch.empty(2, 40, 3, 64, dtype=torch.float32, device="cuda")
        out, S = gs.gla_scan(g, g, g, ld, chunk=16)
        assert out.shape == g.shape and S.shape == (2, 3, 64, 64) and S.dtype == torch.float32
        one = g.narrow(2, 0, 1)                   # one group over the heads
        grads = gs.gla_scan_bwd(one, one, g, ld, None, out, S, chunk=16)
        assert [tuple(t.shape) for t in grads[:4]] == [(2, 40, 1, 64)] * 2 + [(2, 40, 3, 64)] * 2
    assert c.kernels == {"flash_attention": 1, "flash_attention_bwd": 1, "gla_scan": 1,
                         "gla_scan_bwd": 1}
    pairs = 64 * 65 // 2
    # flash: the forward's 2 products and the backward's 7, 2 flops a
    # multiply-add, over B 2 x H 4 heads of 128 and the causal pairs
    assert c.flops == (2 + 7) * 2 * 2 * 4 * 128 * pairs + gs.chunked_flops(
        2, 40, 3, 64, 64, 16) + gs.chunked_flops(2, 40, 3, 64, 64, 16, backward=True)
    # the backward's workspaces are made as for a launch: the group's (2, B,
    # L, H, dk) f32 among them
    assert c.peak_bytes >= 2 * 2 * 40 * 3 * 64 * 4
    assert (fa.COUNTER.launches, fa.BWD_COUNTER.launches, gs.COUNTER.launches,
            gs.BWD_COUNTER.launches) == before


def test_real_cpu_tensors_at_a_cuda_launcher_raise_as_before():
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.gla_scan import gla_scan as gs

    q = torch.zeros(1, 2, 8, 64)
    with pytest.raises(ValueError, match="must be CUDA tensors"):
        fa.flash_attention(q, q, q)
    g = torch.zeros(1, 8, 2, 64)
    with pytest.raises(ValueError, match="must be CUDA"):
        gs.gla_scan(g, g, g, g)


def test_uses_mma_copies_the_libraries_rule():
    from repro_torch.kernels.gla_scan import gla_scan as gs

    src = (ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "gla_scan_bwd.cu").read_text()
    assert ("return qkv_dtype == 1 && dk % 16 == 0 && dv % 16 == 0 && dk <= 128 && dv <= 128 "
            "&&\n         (c == 16 || c == 32 || c == 64);") in src
    assert gs.uses_mma(torch.bfloat16, 64, 64, 64)
    assert not gs.uses_mma(torch.float32, 64, 64, 64)
    assert not gs.uses_mma(torch.bfloat16, 64, 72, 64) and not gs.uses_mma(
        torch.bfloat16, 64, 64, 48)


def test_kernel_entries_on_a_fake_card_mesh_launch_fakes(world_results):
    res = _case(world_results, "routing")
    assert res["kernels"] == {"flash_attention": 1, "gla_scan": 1}
    assert res["attend_local_shape"] == [2, 16, 2, 64]       # batch and heads split
    assert res["gla_local_shape"] == [2, 16, 2, 64]


def test_the_dry_run_refuses_a_running_group():
    code = ("import torch.distributed as dist\n"
            "from repro_torch.launch import dryrun\n"
            "dist.init_process_group('gloo', init_method='tcp://localhost:%d', world_size=1, "
            "rank=0)\n"
            "try:\n    dryrun.main(['--arch', 'yi-6b', '--shape', 'decode_32k', '--device', "
            "'cpu'])\nexcept RuntimeError as e:\n    print('refused:', e)\n")
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code % port], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120).stdout
    assert "refused: the dry run starts its own fake process group" in out


@pytest.mark.parametrize("flag,why", [("--seq-par-attn", "splits heads, never positions"),
                                      ("--flash", "--device cuda already attends")])
def test_the_dry_run_refuses_a_policy_it_would_not_apply(flag, why, capsys):
    """The reference's policy flags the port's step does not read exit with
    an error before any group starts, rather than tag records of a step
    that ran without them."""
    from repro_torch.launch import dryrun

    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "yi-6b", "--shape", "decode_32k", "--device", "cpu", flag])
    assert e.value.code == 2
    assert why in capsys.readouterr().err


# ---------------------------------------------------------------------------
# The subprocess cases (this file run as a script)
# ---------------------------------------------------------------------------


def bytes_case() -> dict:
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh

    out = {}
    for name in sorted(MESHES):
        multi = name == "pod2x16x16"
        dryrun.start_fake_world(512 if multi else 256)
        try:
            mesh = make_production_mesh(multi_pod=multi, device="cpu")
            out[name] = {}
            for arch in ARCHS:
                with FakeTensorMode(allow_non_fake_inputs=True):
                    _, _, args = dryrun.placed_inputs(arch, "decode_32k", mesh, device="cpu")
                    out[name][arch] = {"params": dryrun.local_bytes(args[0]),
                                       "state": dryrun.local_bytes(args[2])}
        finally:
            dryrun.stop_world()
    return out


def counter_case() -> dict:
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.analysis.counter import CostCounter
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh

    dryrun.start_fake_world(256)
    try:
        mesh = make_production_mesh(device="cpu")
        fake = FakeTensorMode(allow_non_fake_inputs=True)
        with fake:
            x = distribute_tensor(torch.empty(65536, 4096, dtype=torch.bfloat16), mesh,
                                  [Shard(0), Replicate()], src_data_rank=None)
            w = distribute_tensor(torch.empty(4096, 14336, dtype=torch.bfloat16), mesh,
                                  [Replicate(), Shard(1)], src_data_rank=None)
            with CostCounter(fake) as c:
                y = x @ w
            mm = c.result()
            with CostCounter(fake) as c:
                x.redistribute(mesh, [Replicate(), Replicate()])
            gather = c.result()
        return {"mm_flops": mm["flops"], "mm_local_shape": list(y.to_local().shape),
                "mm_collectives": mm["collectives"], "mm_peak": mm["peak_bytes"],
                "mm_live": mm["live_bytes"], "gather_collectives": gather["collectives"],
                "gather_flops": gather["flops"]}
    finally:
        dryrun.stop_world()


def smoke_case(part: int = 0, parts: int = 1) -> dict:
    import tempfile

    from repro_torch.launch import dryrun

    for key in ("train_4k", "prefill_32k"):
        dryrun.SHAPES[key] = dict(dryrun.SHAPES[key], seq=SMOKE_SEQ)
    out = {}
    dryrun.start_fake_world(256)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            for arch in ARCHS[part::parts]:
                for shape in SHAPES:
                    try:
                        out[f"{arch}__{shape}"] = dryrun.run_combo(
                            arch, shape, False, tmp, device="cpu", smoke=True)
                    except Exception as e:          # the test reports it
                        out[f"{arch}__{shape}"] = {"status": "FAIL", "error": repr(e)[-2000:]}
    finally:
        dryrun.stop_world()
    return out


def flops_case() -> dict:
    from repro_torch.launch import dryrun

    return {arch: {kind: dryrun.reckon_host(arch, shape, device="cpu", smoke=True)["flops"]
                   for kind, shape in FLOP_SHAPES.items()
                   if kind != "train" or arch in ("yi-6b", "qwen3-moe-30b-a3b")}
            for arch in FAMILY_ARCHS}


def routing_case() -> dict:
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.analysis.counter import CostCounter
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention.ops import attend
    from repro_torch.kernels.gla_scan.ops import gla
    from repro_torch.launch import dryrun

    def refuse(*a, **k):
        raise AssertionError("a build under fake tensors")

    build.load = build.build_all = refuse
    dryrun.start_fake_world(4)
    try:
        mesh = init_device_mesh("cuda", (2, 2), mesh_dim_names=("data", "model"))
        fake = FakeTensorMode(allow_non_fake_inputs=True)
        with fake:
            def placed(*shape, dtype=torch.bfloat16):
                return distribute_tensor(torch.empty(shape, dtype=dtype, device="cuda"), mesh,
                                         [Shard(0), Replicate()], src_data_rank=None)

            q = placed(4, 16, 4, 64)
            with CostCounter(fake) as c:
                o = attend(q, q, q, causal=True)
                g, S = gla(q, q, q, placed(4, 16, 4, 64, dtype=torch.float32))
        return {"kernels": c.kernels, "attend_local_shape": list(o.to_local().shape),
                "gla_local_shape": list(g.to_local().shape)}
    finally:
        dryrun.stop_world()


if __name__ == "__main__":
    case, path = sys.argv[1:]
    torch.set_num_threads(1)
    result = {"bytes": bytes_case, "counter": counter_case,
              "smoke0": lambda: smoke_case(part=0, parts=2),
              "smoke1": lambda: smoke_case(part=1, parts=2),
              "flops": flops_case,
              "routing": routing_case}[case]()
    Path(path).write_text(json.dumps(result))
