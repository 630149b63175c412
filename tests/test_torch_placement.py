"""Backbone placement on a mesh (``serving.sharded``, ``mesh=``, the
distributed BNS step), on the CPU.

The reference's four mesh tests fail on jax 0.9.0 through its
``make_host_mesh``; their port twins run here on a gloo 1 x 1 mesh (a
process group of one rank) and are held against the port's unsharded
paths: the flow gateway's and the continuous gateway's rows within the
reference's atol 1e-6, the distributed step's loss falling as in
``tests/test_ns_properties.py``, and the launcher's ``--mesh host``. Two
cases run two gloo ranks in subprocesses, each under its own timeout: the
flow gateway on a (2, 1) mesh, the batch split over the ranks, within f32
2e-5 of the unsharded rows; and ``make_distributed_bns_step`` over two
ranks, within 2e-5 of one step on the whole batch. Each rank is this file
run as a script,

    python tests/test_torch_placement.py CASE RANK WORLD PORT OUT

joining a gloo group at ``tcp://localhost:PORT``; rank 0 writes what the
test compares to OUT (an ``.npz``). Beside them: every kernel entry given
DTensors runs its kernel's CPU route on the local shards through
``local_map``, the placers, the decode gateway over the mesh for each state
kind, the ambient sharding context, and ``serving_mesh``'s fallback
warning.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.core import schedulers, toy
from repro_torch.core.anytime import init_anytime
from repro_torch.core.bns import BNSTrainConfig, generate_pairs, make_distributed_bns_step
from repro_torch.distributed import context
from repro_torch.distributed.sharding import Spec
from repro_torch.launch.mesh import batch_axes, make_host_mesh
from repro_torch.models import model as M
from repro_torch.serving import (
    AnytimeFlowSampler,
    ContinuousGateway,
    DecodeEngine,
    DecodeGateway,
    DecodeRequest,
    Gateway,
    Request,
    ShapeLadder,
)
from repro_torch.serving import sharded
from repro_torch.serving.toy import FakeClock

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUDGETS = (2, 4)
TOL = 2e-5


@pytest.fixture(scope="module")
def mesh():
    return make_host_mesh("cpu")


@pytest.fixture(scope="module")
def backbone():
    cfg = get_config("yi-6b", smoke=True)
    params = M.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    tok = torch.randint(0, cfg.vocab, (4, 8), generator=torch.Generator().manual_seed(1))

    def make_sampler():
        return AnytimeFlowSampler(params=params, cfg=cfg, sched=schedulers.fm_ot(),
                                  anytime=init_anytime(None, BUDGETS, "nested"),
                                  budgets=BUDGETS)

    return cfg, tok, make_sampler


def _x0(cfg, n=2, seed=7):
    return np.random.default_rng(seed).standard_normal((n, 8, cfg.latent_dim)).astype(
        np.float32)


# ---------------------------------------------------------------------------
# The reference's four mesh tests, on the port
# ---------------------------------------------------------------------------


def test_backbone_sharded_gateway_matches_unsharded(backbone, mesh):
    """mesh= places params and batches (1 x 1 host mesh); rows equal the
    single-device path."""
    cfg, toks, make_sampler = backbone
    ref_sampler = make_sampler()
    gw = Gateway(make_sampler(), max_batch=2, max_wait_ms=10.0, mesh=mesh, clock=FakeClock())
    x0 = _x0(cfg)
    futs = [gw.submit(Request(tokens=toks[i], budget=2, x0=x0[i])) for i in range(2)]
    assert gw.pump() == 1
    direct = ref_sampler.sample_from({"tokens": toks[:2]}, x0, 2)
    for i, f in enumerate(futs):
        np.testing.assert_allclose(f.result().latents, direct[i].numpy(), atol=1e-6)
    from torch.distributed.tensor import DTensor

    assert isinstance(gw.sampler.params["layers"]["attn"]["wq"], DTensor)


def test_backbone_sharded_continuous_matches_unsharded(backbone, mesh):
    cfg, toks, make_sampler = backbone
    ref_sampler = make_sampler()
    gw = ContinuousGateway(make_sampler(), max_slots=2, max_wait_ms=10.0, mesh=mesh,
                           clock=FakeClock())
    x0 = _x0(cfg)
    futs = [gw.submit(Request(tokens=toks[i], budget=(2, 4)[i], x0=x0[i]))
            for i in range(2)]
    gw.drain()
    ref2 = ref_sampler.sample_from({"tokens": toks[:1]}, x0[:1], 2)
    ref4 = ref_sampler.sample_from({"tokens": toks[1:2]}, x0[1:], 4)
    np.testing.assert_allclose(futs[0].result().latents, ref2[0].numpy(), atol=1e-6)
    np.testing.assert_allclose(futs[1].result().latents, ref4[0].numpy(), atol=1e-6)


def test_sharded_continuous_joins_match_the_unsharded_gateway(backbone, mesh):
    """Joins mid-trajectory scatter into the carry, which is re-placed on the
    mesh; every row equals the unsharded continuous gateway's."""
    cfg, toks, make_sampler = backbone
    x0 = _x0(cfg, n=4, seed=3)
    out = []
    for m in (None, mesh):
        clock = FakeClock()
        gw = ContinuousGateway(make_sampler(), max_slots=2, max_wait_ms=10.0, mesh=m,
                               clock=clock)
        futs = [gw.submit(Request(tokens=toks[0], budget=4, x0=x0[0])),
                gw.submit(Request(tokens=toks[1], budget=2, x0=x0[1]))]
        clock.advance(1.0)
        gw.pump()
        futs += [gw.submit(Request(tokens=toks[i], budget=(2, 4)[i % 2], x0=x0[i]))
                 for i in (2, 3)]
        gw.drain()
        out.append(([f.result() for f in futs], gw.stats()))
    (plain, plain_stats), (placed, placed_stats) = out
    for a, b in zip(plain, placed):
        np.testing.assert_allclose(b.latents, a.latents, atol=1e-6)
        assert b.meta.get("join_step") == a.meta.get("join_step")
    assert placed_stats["joins"] == plain_stats["joins"] > 0


def _field():
    return toy.mixture_field(schedulers.fm_ot(), toy.two_moons_means(),
                             torch.full((16,), 0.15), torch.ones((16,)))


def test_distributed_bns_step_runs_and_learns(mesh):
    """The Algorithm-2 step on the (1, 1) host mesh: the loss falls and theta
    stays finite (``tests/test_ns_properties.py``'s case)."""
    field = _field()
    cfg = BNSTrainConfig(nfe=4, init_solver="euler", iterations=50, lr=2e-3)
    step_fn, theta, opt = make_distributed_bns_step(field, cfg, mesh)
    x0, x1 = generate_pairs(field, torch.Generator().manual_seed(0), 64, (2,))
    losses = []
    for it in range(50):
        theta, opt, loss = step_fn(theta, opt, it, x0, x1)
        losses.append(float(loss))
    assert losses[-1] < losses[0] - 0.5, (losses[0], losses[-1])
    for leaf in theta:
        assert bool(torch.isfinite(leaf).all())


def test_distributed_bns_step_equals_the_plain_step(mesh):
    """At one rank the step is the plain Algorithm-2 step (the PSNR loss,
    autograd, Adam at the host-computed rate), to the bit."""
    from repro_torch.core.bns import _loss_fn, ns_sampler
    from repro_torch.optim.adam import adam_update, tree_leaves, tree_map, tree_unflatten
    from repro_torch.optim.schedule import poly_decay

    field = _field()
    cfg = BNSTrainConfig(nfe=4, init_solver="euler", iterations=10, lr=2e-3)
    step_fn, theta, opt = make_distributed_bns_step(field, cfg, mesh)
    x0, x1 = generate_pairs(field, torch.Generator().manual_seed(1), 32, (2,))
    th, op = theta, opt
    lr_fn = poly_decay(cfg.lr, cfg.iterations)      # the config's default schedule
    for it in range(3):
        theta, opt, loss = step_fn(theta, opt, it, x0, x1)
        g_th = tree_map(lambda p: p.detach().requires_grad_(True), th)
        plain = _loss_fn(ns_sampler(field), g_th, x0, x1)
        grads = torch.autograd.grad(plain, tree_leaves(g_th))
        with torch.no_grad():
            th, op = adam_update(tree_unflatten(th, list(grads)), op, th,
                                 torch.tensor(float(lr_fn(it)), dtype=torch.float32))
        assert float(loss) == float(plain.detach())
    for a, b in zip(tree_leaves(theta), tree_leaves(th)):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(opt), tree_leaves(op)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# Two gloo ranks, each case in its own subprocesses and timeout
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _two_ranks(case: str, tmp_path) -> dict:
    out = str(tmp_path / f"{case}.npz")
    port = str(_free_port())
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), case, str(r), "2",
                               port, out],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-4000:]
    return dict(np.load(out))


def test_two_rank_flow_gateway_matches_unsharded_rows(tmp_path):
    res = _two_ranks("gateway", tmp_path)
    assert list(res["placements"]) == ["S(0)", "R"]        # the batch split over data
    np.testing.assert_allclose(res["rows"], res["unsharded"], atol=TOL, rtol=TOL)


def test_two_rank_distributed_bns_step_equals_the_whole_batch_step(tmp_path):
    res = _two_ranks("bns", tmp_path)
    np.testing.assert_allclose(res["theta"], res["theta_whole"], atol=TOL, rtol=TOL)
    np.testing.assert_allclose(res["loss"], res["loss_whole"], atol=TOL, rtol=TOL)


# ---------------------------------------------------------------------------
# Kernel entries under DTensor (the CPU routes, through local_map)
# ---------------------------------------------------------------------------


def _spy(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def spy(*args, **kw):
        calls.append(tuple(type(a) for a in args if isinstance(a, torch.Tensor)))
        return real(*args, **kw)

    monkeypatch.setattr(module, name, spy)
    return calls


def test_kernel_entries_run_on_local_shards(mesh, monkeypatch):
    from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import attention_ref, paged_attention_ref
    from repro_torch.kernels.ns_update import ops as nops
    from repro_torch.kernels.ns_update.ref import ns_update_ref

    g = torch.Generator().manual_seed(0)
    rep = [Replicate(), Replicate()]
    bat = [Shard(0), Replicate()]

    def dt(x, pl):
        return distribute_tensor(x, mesh, pl, src_data_rank=None)

    x0, u = torch.randn(4, 8, 16, generator=g), torch.randn(3, 4, 8, 16, generator=g)
    a, w = torch.tensor(0.5), torch.randn(3, generator=g)
    ns_calls = _spy(monkeypatch, nops, "ns_update_ref")
    out = nops.fused_ns_update(dt(x0, bat), dt(u, [Shard(1), Replicate()]), a, w)
    assert isinstance(out, DTensor) and out.placements == tuple(rep)   # one rank an axis
    assert ns_calls == [(torch.Tensor,) * 4]            # the plain route, on local shards
    assert torch.equal(out.full_tensor(), ns_update_ref(x0, u, a, w))

    q, k = torch.randn(2, 16, 4, 32, generator=g), torch.randn(2, 16, 2, 32, generator=g)
    v = torch.randn(2, 16, 2, 32, generator=g)
    fl_calls = _spy(monkeypatch, fops, "attention_ref")
    out = fops.attend(dt(q, bat), dt(k, rep), dt(v, rep))
    assert isinstance(out, DTensor) and fl_calls == [(torch.Tensor,) * 3]
    want = attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                         causal=True).transpose(1, 2)
    assert torch.equal(out.full_tensor(), want)

    qg = torch.randn(2, 2, 2, 32, generator=g)
    pages = torch.randn(2, 5, 4, 2, 32, generator=g)
    table = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    lengths = torch.tensor([5, 7], dtype=torch.int32)
    pg_calls = _spy(monkeypatch, fops, "paged_attention_ref")
    out = fops.paged_attend(dt(qg, bat), dt(pages[0], rep), dt(pages[1], rep), table, lengths)
    assert isinstance(out, DTensor) and pg_calls == [(torch.Tensor,) * 5]
    assert torch.equal(out.full_tensor(),
                       paged_attention_ref(qg, pages[0], pages[1], table, lengths))


def test_cuda_launchers_refuse_a_dtensor(mesh):
    """A DTensor that reaches a CUDA-only launcher with no local_map raises,
    and the message says so (before any pointer is read)."""
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.kernels.flash_attention.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention.paged_attention import paged_attention
    from repro_torch.kernels.ns_update.ns_update import ns_update

    x = distribute_tensor(torch.randn(2, 4, 2, 64), mesh, [Replicate(), Replicate()],
                          src_data_rank=None)
    one = torch.zeros(1, dtype=torch.int32)
    for call in (lambda: ns_update(x, x[None], torch.tensor(1.0), torch.ones(1)),
                 lambda: flash_attention(x, x, x),
                 lambda: paged_attention(x, x, x, one, one)):
        with pytest.raises(TypeError, match="DTensor with no local_map"):
            call()


# ---------------------------------------------------------------------------
# Placers, the decode gateway, the context, serving_mesh
# ---------------------------------------------------------------------------


class _Mesh:
    """Axis names and sizes: all ``placements_for`` reads of a mesh."""

    def __init__(self, **sizes):
        self.mesh_dim_names, self._sizes = tuple(sizes), tuple(sizes.values())

    def size(self, i):
        return self._sizes[i]


def test_placements_follow_the_spec_on_axes_of_more_than_one_rank():
    from torch.distributed.tensor import Replicate, Shard

    assert sharded.placements_for(_Mesh(data=2, model=4), Spec(None, "data", "model")) == \
        [Shard(1), Shard(2)]
    assert sharded.placements_for(_Mesh(pod=2, data=2, model=1),
                                  Spec(("pod", "data"), None)) == \
        [Shard(0), Shard(0), Replicate()]
    assert sharded.placements_for(_Mesh(data=1, model=4), Spec("data", "model")) == \
        [Replicate(), Shard(1)]
    assert sharded.placements_for(_Mesh(data=2, model=2), Spec()) == [Replicate()] * 2


def test_placers_place_the_batch_and_cache_tier_shardings(mesh):
    from torch.distributed.tensor import DTensor, Replicate

    cond, x0 = sharded.batch_placer(mesh)({"tokens": torch.zeros(4, 8, dtype=torch.long)},
                                          torch.zeros(4, 8, 2))
    # one rank a mesh axis: the data split is the whole batch
    assert isinstance(x0, DTensor) and x0.placements == (Replicate(), Replicate())
    assert isinstance(cond["tokens"], DTensor)
    place = sharded.tier_placer(mesh, ShapeLadder((8, 16)))
    for shape in ((4, 8, 2), (2, 16, 2), (4, 8, 2), (4, 5, 2)):
        place(None, torch.zeros(shape))
    assert sorted(place.cache) == [(2, 16, 2), (4, 8, 2)]     # off-ladder 5 not cached
    carry = sharded.carry_placer(mesh)(
        init_anytime.__globals__["AnytimeCarry"](x0=torch.zeros(2, 8, 2),
                                                 U=torch.zeros(4, 2, 8, 2),
                                                 x=torch.zeros(2, 8, 2), step=0))
    assert isinstance(carry.U, DTensor) and carry.step == 0
    assert batch_axes(mesh) == ("data",)


@pytest.mark.parametrize("arch,page_size", [
    ("yi-6b", 4), ("yi-6b", 0), ("rwkv6-7b", 0), ("zamba2-2.7b", 0),
    ("qwen3-moe-30b-a3b", 4)])
def test_decode_gateway_on_the_mesh_matches_unsharded(arch, page_size, mesh):
    """DecodeGateway(mesh=) places the weights and the slot state (paged
    pools, dense caches, recurrent states); tokens equal the unsharded
    gateway's."""
    cfg = get_config(arch, smoke=True)

    def serve(m):
        params = M.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
        engine = DecodeEngine(params=params, cfg=cfg, page_size=page_size,
                              paged_kernel=bool(page_size))
        gw = DecodeGateway(engine, max_slots=2, cache_slots=32, prefill_chunk=4, mesh=m)
        futs = [gw.submit(DecodeRequest(prompt=[(3 * r + 1) % cfg.vocab,
                                                (5 * r + 2) % cfg.vocab],
                                        max_tokens=(5, 3)[r % 2])) for r in range(3)]
        gw.drain()
        return [f.result().tokens for f in futs], gw

    plain, _ = serve(None)
    placed, gw = serve(mesh)
    for a, b in zip(plain, placed):
        np.testing.assert_array_equal(a, b)
    from torch.distributed.tensor import DTensor

    assert all(isinstance(leaf, DTensor) for leaf in gw._state if leaf.dim())


def test_context_helpers_are_no_ops_without_a_context(mesh):
    from torch.distributed.tensor import DTensor, Replicate, distribute_tensor

    context.clear()
    x = torch.ones(4, 2)
    assert context.constrain(x, "data", None) is x
    assert context.active() is None and context.batch_axis() is None
    assert not context.seq_parallel_attn_enabled() and context.q_chunk() == 0
    assert not context.flash_attention_enabled()
    try:
        ctx = context.install(mesh, q_chunk=128, flash_attention=True)
        assert context.active() is ctx and context.batch_axis() == "data"
        assert context.q_chunk() == 128 and context.flash_attention_enabled()
        d = distribute_tensor(torch.ones(4, 2), mesh, [Replicate(), Replicate()],
                              src_data_rank=None)
        assert isinstance(context.constrain(d, "data", None), DTensor)
        assert context.constrain(x, "data") is x            # a plain tensor is local
    finally:
        context.clear()


def test_serving_mesh_warns_and_falls_back_without_the_ranks(capsys):
    assert sharded.serving_mesh("none") is None
    for name, ranks in (("production", 256), ("multipod", 512)):
        assert sharded.serving_mesh(name, "cpu") is None
        out = capsys.readouterr().out
        assert f"WARNING: cannot build {name!r} mesh" in out and f"needs {ranks} ranks" in out
        assert "falling back to single-device jit" in out
    with pytest.raises(ValueError, match="unknown mesh"):
        sharded.serving_mesh("ring")


def test_host_mesh_reuses_the_running_group(mesh):
    again = make_host_mesh("cpu")
    assert tuple(again.mesh_dim_names) == ("data", "model") and tuple(again.shape) == (1, 1)


def test_serve_mesh_host_continuous_on_the_cpu(capsys):
    from repro_torch.launch import serve

    served = serve.main(["--arch", "yi-6b", "--mode", "flow", "--batch", "2", "--seq", "4",
                         "--device", "cpu", "--budgets", "2,4", "--bns-iters", "0",
                         "--gateway", "--continuous", "--max-slots", "2", "--mesh", "host",
                         "--request-budgets", "2,4", "--requests", "3"])
    assert "gateway stats: done=3/3" in capsys.readouterr().out
    assert all(r is not None for r in served.responses)


# ---------------------------------------------------------------------------
# One rank of the two-rank cases (this file run as a script)
# ---------------------------------------------------------------------------


def gateway_case():
    from repro_torch.configs import get_config
    from repro_torch.core.anytime import init_anytime
    from repro_torch.core.schedulers import fm_ot
    from repro_torch.models import model as M
    from repro_torch.serving import AnytimeFlowSampler, Gateway, Request
    from repro_torch.serving.toy import FakeClock

    cfg = get_config("yi-6b", smoke=True)
    budgets = (2, 4)
    mesh = _mesh()

    def sampler():
        params = M.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
        return AnytimeFlowSampler(params=params, cfg=cfg, sched=fm_ot(),
                                  anytime=init_anytime(None, budgets, "nested"),
                                  budgets=budgets)

    rng = np.random.default_rng(7)
    x0 = rng.standard_normal((4, 8, cfg.latent_dim)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab, (4, 8))
    req = [(2, 0), (2, 1), (4, 2), (4, 3)]
    gw = Gateway(sampler(), max_batch=2, max_wait_ms=10.0, mesh=mesh, clock=FakeClock(),
                 mixed_budget_policy="never")
    futs = [gw.submit(Request(tokens=torch.from_numpy(toks[i]), budget=b, x0=x0[i]))
            for b, i in req]
    gw.drain()
    rows = np.stack([f.result().latents for f in futs])
    plain = sampler()
    alone = np.concatenate([
        plain.sample_from({"tokens": torch.from_numpy(toks[:2])}, x0[:2], 2).numpy(),
        plain.sample_from({"tokens": torch.from_numpy(toks[2:])}, x0[2:], 4).numpy()])
    return {"rows": rows, "unsharded": alone,
            "placements": np.array([str(p) for p in gw._place(None, torch.from_numpy(x0[:2]))[1]
                                    .placements])}


def bns_case():
    from repro_torch.core import schedulers, toy
    from repro_torch.core.bns import BNSTrainConfig, generate_pairs, make_distributed_bns_step

    field = toy.mixture_field(schedulers.fm_ot(), toy.two_moons_means(),
                              torch.full((16,), 0.15), torch.ones((16,)))
    cfg = BNSTrainConfig(nfe=4, init_solver="euler", iterations=50, lr=2e-3)
    x0, x1 = generate_pairs(field, torch.Generator().manual_seed(0), 64, (2,))
    mesh = _mesh()
    step, theta, opt = make_distributed_bns_step(field, cfg, mesh)
    one = {"data": 1, "model": 1}
    single, theta1, opt1 = make_distributed_bns_step(field, cfg, _OneRank(one))
    losses, losses1 = [], []
    for it in range(3):
        theta, opt, loss = step(theta, opt, it, x0, x1)
        theta1, opt1, loss1 = single(theta1, opt1, it, x0, x1)
        losses.append(float(loss))
        losses1.append(float(loss1))
    from repro_torch.optim.adam import tree_leaves

    return {"theta": np.concatenate([p.reshape(-1).numpy() for p in tree_leaves(theta)]),
            "theta_whole": np.concatenate([p.reshape(-1).numpy()
                                           for p in tree_leaves(theta1)]),
            "loss": np.array(losses), "loss_whole": np.array(losses1)}


class _OneRank:
    """A mesh of one rank that no process group holds (the unsharded step
    beside the sharded one, in the same process)."""

    device_type = "cpu"

    def __init__(self, sizes):
        self.mesh_dim_names = tuple(sizes)
        self.shape = tuple(sizes.values())
        self._sizes = sizes

    def size(self, i):
        return 1

    def get_coordinate(self):
        return [0] * len(self._sizes)

    def get_group(self, i):
        raise AssertionError("a one-rank axis runs no collective")


def _mesh():
    """The (WORLD, 1) ("data", "model") mesh over the running group."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh("cpu", (dist.get_world_size(), 1),
                            mesh_dim_names=("data", "model"))


def _rank_main(case, rank, world, port, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=int(world), rank=int(rank))
    try:
        result = {"gateway": gateway_case, "bns": bns_case}[case]()
        if int(rank) == 0:
            np.savez(out, **result)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(*sys.argv[1:])
