"""Tensor parallelism with a ``model`` axis of more than one rank, on real
numbers: the port's train, prefill and decode steps on gloo ranks, held
against the unsharded path at f32 TOL (2e-5, relative to each output's
largest magnitude).

Each mesh runs as this file run as a script, once a rank,

    python tests/test_torch_model_axis.py ROWS COLS RANK PORT OUT

joining a gloo group of ROWS x COLS ranks at ``tcp://localhost:PORT`` with
the ("data", "model") mesh (ROWS, COLS); every case runs the step twice in
each rank, on the params placed by ``serving.sharded.shard_params`` (the
production rules) under ``context.install`` and on the same plain tensors,
and rank 0 writes both to OUT (an ``.npz``). The smoke configs' head counts
are chosen against the meshes so that the KV heads do NOT divide ``model``:

  (1, 4)  yi-6b's 2 KV heads over 4: the decode cache splits its slots on
          ``model`` (each rank writes the rows whose slot it holds, and the
          ranks' softmax partials merge by log-sum-exp); 8 query heads of
          32 split, 2 KV heads gathered; qwen3-moe-235b-a22b's 4 experts one
          a rank (scatter dispatch), qwen3-moe-30b-a3b's (onehot);
          zamba2-2.7b's SSD heads; rwkv6-7b's 2 heads over 4 (gathered).
  (2, 2)  the batch split over ``data`` too; yi-6b with one KV head, so a
          batch of one (the long_500k fallback) splits the slots over the
          data axes, and a batch of two over ``model``.

Cases: decode logits and greedy tokens over several steps into the
slot-split cache (a ring under a window too), MoE (with its load-balance
loss, the batch split on 2 x 2), zamba2-2.7b, rwkv6-7b, whisper-medium
(frames, cross-attention) and internvl2-26b (patches) prefill, and a train
step's loss and every gradient (``cfm_loss`` with
remat). The ranks' collectives are gloo's, so each case is a real
all-gather / all-reduce / reduce-scatter of these values.
"""
import dataclasses
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 2e-5
MESHES = {"1x4": (1, 4), "2x2": (2, 2)}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_mesh(rows: int, cols: int, out: str) -> subprocess.Popen:
    port = str(_free_port())
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    return [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(rows), str(cols),
                              str(r), port, out], env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for r in range(rows * cols)]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Both meshes' ranks started together, each mesh under one timeout."""
    tmp = tmp_path_factory.mktemp("model_axis")
    runs = {name: (str(tmp / f"{name}.npz"), _run_mesh(*shape, str(tmp / f"{name}.npz")))
            for name, shape in MESHES.items()}
    out, logs = {}, []
    try:
        for name, (path, procs) in runs.items():
            for p in procs:
                logs.append(p.communicate(timeout=400)[0])
            assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-6000:]
            out[name] = dict(np.load(path))
    finally:
        for _, procs in runs.values():
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    return out


CASES = {
    "1x4": ["decode_yi-6b", "decode_window_yi-6b", "prefill_qwen3-moe-235b-a22b",
            "prefill_qwen3-moe-30b-a3b", "prefill_zamba2-2.7b", "prefill_rwkv6-7b",
            "prefill_whisper-medium", "prefill_internvl2-26b", "decode_zamba2-2.7b",
            "decode_rwkv6-7b", "train_yi-6b", "train_qwen3-moe-235b-a22b", "train_zamba2-2.7b"],
    "2x2": ["decode_yi-6b", "decode_batch1_mqa", "decode_batch2_mqa",
            "prefill_qwen3-moe-235b-a22b", "prefill_whisper-medium", "train_yi-6b"],
}


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("mesh,case", [(m, c) for m, cases in CASES.items() for c in cases],
                         ids=lambda x: x)
def test_sharded_step_equals_the_unsharded_one(results, mesh, case):
    res = results[mesh]
    keys = sorted(k[len(case) + 1:-len(".sharded")] for k in res
                  if k.startswith(case + ":") and k.endswith(".sharded"))
    assert keys, f"no outputs recorded for {case}"
    for key in keys:
        got, want = res[f"{case}:{key}.sharded"], res[f"{case}:{key}.plain"]
        assert got.shape == want.shape, key
        if key.startswith("tokens"):
            np.testing.assert_array_equal(got, want, err_msg=key)
        else:
            _close(got, want)


def test_the_meshes_split_what_the_cases_say(results):
    """The layouts the cases are about, read off the placed DTensors."""
    for mesh, want in (("1x4", {"decode_yi-6b": "slots:model",
                                "prefill_qwen3-moe-235b-a22b": "experts:model"}),
                       ("2x2", {"decode_batch1_mqa": "slots:data",
                                "decode_batch2_mqa": "batch:data,slots:model"})):
        for case, layout in want.items():
            assert str(results[mesh][f"{case}:layout"]) == layout, (mesh, case)


# ---------------------------------------------------------------------------
# One rank (this file run as a script)
# ---------------------------------------------------------------------------


def _np(x):
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        x = x.full_tensor()
    return x.detach().to(torch.float32).numpy()


def _params(cfg):
    from repro_torch.models import model as M

    return M.init_params(torch.Generator().manual_seed(0), cfg, "cpu")


def _redrawn_norms(params):
    """Every norm scale and per-head vector redrawn near 1 (the init's ones
    would leave their gradient paths trivial)."""
    from repro_torch.optim.adam import tree_map

    g = torch.Generator().manual_seed(5)
    return tree_map(lambda x: x if x.dim() > 2 or x.dtype != torch.float32
                    else x + 0.1 * torch.randn(x.shape, generator=g), params)


def _layout(buf, dim_names) -> str:
    from torch.distributed.tensor import Shard

    mesh = buf.device_mesh
    return ",".join(f"{dim_names[p.dim]}:{mesh.mesh_dim_names[i]}"
                    for i, p in enumerate(buf.placements) if isinstance(p, Shard)
                    and p.dim in dim_names)


def _both(mesh, fn, *, place):
    """fn(placed) on the mesh under the context, and fn(plain) without."""
    from repro_torch.distributed import context
    from repro_torch.serving import sharded

    plain = fn(lambda tree, kind=None: tree)
    context.install(mesh)
    try:
        with sharded.scope(mesh):
            placed = fn(place)
    finally:
        context.clear()
    return placed, plain


def _placer(mesh, cfg):
    from repro_torch.distributed.sharding import batch_spec
    from repro_torch.serving import sharded

    def place(tree, kind=None):
        if kind == "params":
            return sharded.shard_params(tree, cfg, mesh)
        if kind == "state":
            return sharded.place_decode_state(tree, cfg, mesh)
        if kind == "batch":
            size = 1
            for i, n in enumerate(mesh.mesh_dim_names):
                if n != "model":
                    size *= mesh.size(i)
            return {k: sharded.place(v, mesh, batch_spec(mesh, v.dim() - 1)
                                     if v.shape[0] % size == 0 else sharded.Spec())
                    for k, v in tree.items()}
        return tree
    return place


def _batch(cfg, B, S, seed=3):
    rng = np.random.default_rng(seed)
    out = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)))}
    fe = cfg.frontend
    if fe is not None:
        key = "frames" if fe.kind == "audio_frames" else "patches"
        width = cfg.d_model if cfg.family == "encdec" else fe.embed_dim
        out[key] = torch.from_numpy(
            (0.5 * rng.standard_normal((B, fe.num_tokens, width))).astype(np.float32))
    return out


def prefill_case(mesh, arch):
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models import moe

    cfg = get_config(arch, smoke=True)
    params = _redrawn_norms(_params(cfg))
    batch = _batch(cfg, 4, 16)
    place = _placer(mesh, cfg)

    def run(pl):
        with torch.no_grad():
            out = {"logits": _np(M.lm_apply(pl(params, "params"), cfg, pl(batch, "batch"))),
                   "last": _np(M.lm_apply(pl(params, "params"), cfg, pl(batch, "batch"),
                                          last_only=True))}
            if cfg.family == "moe":     # the load-balance loss, over the whole batch
                out["aux"] = _np(moe.lm_forward(pl(params, "params"), cfg,
                                                pl(batch, "batch")["tokens"])[1])
            return out

    placed, plain = _both(mesh, run, place=place)
    out = {}
    if cfg.family == "moe":
        w = place(params, "params")["layers"]["moe"]["w_gate"]
        out["layout"] = np.array(_layout(w, {1: "experts"}))
    return placed, plain, out


def decode_case(mesh, arch, *, B=2, slots=8, steps=10, window=0, kv=None):
    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    cfg = get_config(arch, smoke=True)
    if kv is not None:
        cfg = dataclasses.replace(cfg, n_kv_heads=kv)
    params = _redrawn_norms(_params(cfg))
    toks = np.random.default_rng(11).integers(0, cfg.vocab, (steps, B))
    place = _placer(mesh, cfg)
    layouts = {}

    def run(pl):
        p = pl(params, "params")
        state = pl(M.init_decode_state(cfg, B, slots, torch.float32, "cpu"), "state")
        if hasattr(getattr(state, "k", None), "placements"):
            layouts["layout"] = _layout(state.k, {2: "slots", 3: "heads", 1: "batch"})
        logits = []
        with torch.no_grad():
            for t in range(steps):
                lg, state = M.decode_apply(p, cfg, torch.from_numpy(toks[t]), state,
                                           window=window)
                logits.append(_np(lg))
        out = np.stack(logits)
        return {"logits": out, "tokens": out.argmax(-1)}

    placed, plain = _both(mesh, run, place=place)
    return placed, plain, {"layout": np.array(layouts.get("layout", ""))}


def train_case(mesh, arch):
    from repro_torch.configs import get_config
    from repro_torch.core.schedulers import fm_ot
    from repro_torch.models import model as M
    from repro_torch.optim.adam import tree_leaves, tree_map

    cfg = get_config(arch, smoke=True)
    params = _redrawn_norms(_params(cfg))
    B, S = 4, 8
    batch = _batch(cfg, B, S)
    rng = np.random.default_rng(9)
    noise = M.CFMNoise(t=torch.from_numpy(rng.uniform(0.05, 0.95, B).astype(np.float32)),
                       x0=torch.from_numpy(rng.standard_normal((B, S, cfg.latent_dim))
                                           .astype(np.float32)),
                       drop=torch.from_numpy(np.array([False, True, False, False])))
    place = _placer(mesh, cfg)

    def run(pl):
        from repro_torch.distributed import context

        live = tree_map(lambda x: x.detach().requires_grad_(True), pl(params, "params"))
        b = context.batch_axis()
        nz = M.CFMNoise(*(pl({"x": x}, "batch")["x"] for x in noise)) if b else noise
        loss = M.cfm_loss(M.unbind_layers(live), cfg, pl(batch, "batch"), fm_ot(),
                          noise=nz, remat=True)
        leaves = tree_leaves(live)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        out = {"loss": _np(loss)}
        for i, g in enumerate(grads):
            if g is not None:
                out[f"grad{i:03d}"] = _np(g)
        return out

    placed, plain = _both(mesh, run, place=place)
    return placed, plain, {}


def _case(mesh, name):
    kind, arch = name.split("_", 1)
    if name == "decode_window_yi-6b":
        return decode_case(mesh, "yi-6b", slots=8, steps=12, window=8)
    if name == "decode_batch1_mqa":
        return decode_case(mesh, "yi-6b", B=1, kv=1)
    if name == "decode_batch2_mqa":
        return decode_case(mesh, "yi-6b", B=2, kv=1)
    return {"prefill": prefill_case, "decode": decode_case, "train": train_case}[kind](
        mesh, arch)


def _rank_main(rows, cols, rank, port, out):
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    rows, cols = int(rows), int(cols)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=rows * cols, rank=int(rank))
    try:
        mesh = init_device_mesh("cpu", (rows, cols), mesh_dim_names=("data", "model"))
        result = {}
        for name in CASES[f"{rows}x{cols}"]:
            placed, plain, extra = _case(mesh, name)
            for k in plain:
                result[f"{name}:{k}.sharded"] = placed[k]
                result[f"{name}:{k}.plain"] = plain[k]
            for k, v in extra.items():
                result[f"{name}:{k}"] = v
        if int(rank) == 0:
            np.savez(out, **result)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(*sys.argv[1:])
