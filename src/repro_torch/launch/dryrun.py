"""Multi-pod dry run: trace every (architecture x input shape) on the
production meshes, with no card, and record what one rank would hold,
compute and send.

Port of ``repro.launch.dryrun``. Where the reference lowers and compiles the
step for 256 or 512 XLA host devices, this runs the port's own step once,
eagerly, on fake tensors (``FakeTensorMode``: shapes, dtypes and devices, no
storage) in a fake process group of 256 or 512 ranks in one process
(``torch.testing._internal.distributed.fake_pg``), laid out by the port's
DTensor placement (``serving.sharded``, ``distributed.sharding``). The
process plays rank 0; its collectives return at once. The steps are the
reference's ``build_step``: train (``cfm_loss`` with remat, its gradient,
``adam_update``), prefill (``lm_apply`` with ``last_only``) and decode
(``decode_apply`` over the dense decode state), under ``context.install``
and ``sharded.scope``. On ``--device cuda`` (the default) the fake tensors
lie on the card, so the steps take the card's paths through the
hand-written kernels' launchers, which on fake tensors allocate their
outputs and launch nothing (``kernels.build.is_fake``); ``--device cpu``
takes the plain paths.

Per combo this writes ``<outdir>/<arch>__<shape>__<mesh>.json`` with the
reference's keys:
  memory       argument, output and temp bytes of one rank (the local
               shards of the inputs; the new storages the step returns; the
               most the step's other storages held at once), and the peak
               (arguments + the most the step's storages held at once),
               from ``analysis.counter``
  flops, bytes, collectives   one rank's totals (``analysis.counter``)
  param_count, active_param_count, devices, lower_s (the trace's seconds)
There is no ``compile_s``, no ``flops_raw`` / ``bytes_raw`` (XLA's own cost
analysis) and no saved HLO, so no ``--reanalyze``: nothing is compiled.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b --shape decode_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--device cpu]

``--device cuda`` needs a torch built with CUDA, a card or not: Python's
indexing and autograd take a device guard of a fake tensor's device, which
a CPU-only torch lacks; there, trace with ``--device cpu``. ``--jobs N``
runs each combo in a process of its own, N at once.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.configs import ARCHS, for_device, get_config
from repro_torch.configs.base import active_param_count
from repro_torch.core.schedulers import get_scheduler
from repro_torch.distributed import context
from repro_torch.distributed.sharding import Spec, param_specs, state_specs, tree_map_with_path
from repro_torch.launch.mesh import batch_axes, make_production_mesh
from repro_torch.models import model as M
from repro_torch.optim.adam import (
    adam_init,
    adam_update,
    tree_leaves,
    tree_map,
    tree_unflatten,
)

# ---------------------------------------------------------------------------
# Input shapes (the reference's table)
# ---------------------------------------------------------------------------

SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode_long", seq=524_288, batch=1),
}

LONG_WINDOW = 8192   # sliding-window size for dense archs on long_500k

F32, BF16, I32 = torch.float32, torch.bfloat16, torch.int32


@dataclasses.dataclass(frozen=True)
class Input:
    """One model input of a combo: its global shape, dtype and ``Spec``."""

    shape: tuple
    dtype: torch.dtype
    spec: Spec


def skip_reason(arch: str, shape: str) -> str | None:
    cfg = get_config(arch)
    if shape == "long_500k":
        if cfg.family == "encdec":
            return ("whisper decoder is full-attention with a 448-token "
                    "practical horizon; 500k decode is not meaningful "
                    "(noted in DESIGN.md)")
    return None


def _shape_info(shape) -> dict:
    return SHAPES[shape] if isinstance(shape, str) else shape


def _batch_entry(mesh, B: int):
    """The reference's ``batch_s``: the composed batch axes where the batch
    is at least the data-parallel width, else None (replicated)."""
    b = batch_axes(mesh)
    b = b if len(b) > 1 else b[0]
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    return b if B >= mesh.size() // sizes["model"] else None


def input_specs(arch: str, shape, mesh, *, smoke: bool = False, device="cpu"):
    """``(cfg, specs)``: an ``Input`` for each model input of a combo, and
    for the decode kinds the state's tree of ``Input`` and the window.
    ``shape`` is a key of ``SHAPES`` or a dict of the same form. A smoke
    config takes ``device``'s head dims (``configs.for_device``: the flash
    kernel's on the card)."""
    cfg = get_config(arch, smoke=smoke)
    if smoke:
        cfg = for_device(cfg, device)
    info = _shape_info(shape)
    B, S = info["batch"], info["seq"]
    batch_s = _batch_entry(mesh, B)

    if info["kind"] in ("train", "prefill"):
        specs = {"tokens": Input((B, S), I32, Spec(batch_s, None))}
        fe = cfg.frontend
        if fe is not None:
            key = "frames" if fe.kind == "audio_frames" else "patches"
            specs[key] = Input((B, fe.num_tokens, fe.embed_dim), BF16,
                               Spec(batch_s, None, None))
        return cfg, specs

    # decode kinds: one token + state
    window = 0
    slots = S
    if info["kind"] == "decode_long":
        window = 0 if cfg.family in ("ssm",) else LONG_WINDOW
        slots = LONG_WINDOW if window else S
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        state = M.init_decode_state(cfg, B, slots, BF16, "cpu",
                                    num_frames=(cfg.frontend.num_tokens
                                                if cfg.frontend else 1500))
    specs = state_specs(state, cfg, mesh, B)
    flat = {}
    tree_map_with_path(lambda p, s: flat.__setitem__(p, s), specs)
    state = tree_map_with_path(
        lambda p, x: Input(tuple(x.shape), x.dtype, flat[p]), state)
    return cfg, {"token": Input((B,), I32, Spec(batch_s)), "state": state,
                 "window": window}


# ---------------------------------------------------------------------------
# Step programs
# ---------------------------------------------------------------------------


def build_step(cfg, kind: str, mesh, window: int = 0):
    sched = get_scheduler("fm_ot")

    if kind == "train":
        def train_step(params, opt, batch, noise):
            # the gradient of each layer's view (``unbind_layers``), as the
            # port's trainer takes it: a stacked leaf's gradient is then its
            # rows, which Adam stacks, and no layer writes a zeroed stack
            with torch.enable_grad():
                live = M.unbind_layers(tree_map(lambda p: p.detach().requires_grad_(True),
                                                   params))
                loss = M.cfm_loss(live, cfg, batch, sched, noise=noise, remat=True)
                leaves = tree_leaves(live)
                grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
            with torch.no_grad():
                params, opt = adam_update(tree_unflatten(live, grads), opt, params, 1e-4)
            return params, opt, loss.detach()
        return train_step

    if kind == "prefill":
        def prefill_step(params, batch):
            # serving prefill: next-token logits only
            with torch.no_grad():
                return M.lm_apply(params, cfg, batch, last_only=True)
        return prefill_step

    def serve_step(params, token, state):
        with torch.no_grad():
            return M.decode_apply(params, cfg, token, state, window=window)
    return serve_step


# ---------------------------------------------------------------------------
# One combo
# ---------------------------------------------------------------------------


def _local_storages(tree) -> dict:
    """``{id: nbytes}`` of the storages the leaves' local shards hold."""
    from torch.distributed.tensor import DTensor

    out = {}
    for x in tree_leaves(tree):
        if isinstance(x, DTensor):
            x = x._local_tensor
        if isinstance(x, torch.Tensor):
            st = x.untyped_storage()
            out[id(st)] = st.nbytes()
    return out


def _placed_input(inp: Input, mesh, device):
    from repro_torch.serving.sharded import place

    return place(torch.empty(inp.shape, dtype=inp.dtype, device=device), mesh, inp.spec)


def _on_device(tree, device, cast=None):
    """``tree``'s leaves made anew on ``device`` (fake: the values are
    never read), cast by ``cast(leaf) -> dtype`` when given."""
    def one(_, x):
        dtype = cast(x) if cast is not None else x.dtype
        return torch.empty(tuple(x.shape), dtype=dtype, device=device)
    return tree_map_with_path(one, tree)


def placed_inputs(arch: str, shape, mesh, *, device="cuda", smoke: bool = False):
    """``(cfg, step, args)`` of a combo: its step (``build_step``) and the
    step's arguments drawn in the active ``FakeTensorMode`` on ``device`` and
    placed on ``mesh``: the params (the reference's ``init_params(dtype=
    bf16)``: matrices bf16, 1-D leaves f32) by ``shard_params``; for train,
    Adam's state placed as the reference places it (``param_specs`` of its
    tree), the batch and the CFM noise on the batch axes; for prefill the
    batch; for decode the token and the dense state by ``state_specs``."""
    from repro_torch.serving import sharded

    info = _shape_info(shape)
    kind = info["kind"]
    cfg, specs = input_specs(arch, shape, mesh, smoke=smoke, device=device)
    params = M.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    params = _on_device(params, device, cast=lambda x: x.dtype if x.dim() == 1 else BF16)
    params = sharded.shard_params(params, cfg, mesh)
    if kind == "train":
        opt = adam_init(params)
        opt = sharded._placed(opt, param_specs(opt, cfg, mesh), mesh)
        batch = {k: _placed_input(v, mesh, device) for k, v in specs.items()}
        B, S = info["batch"], info["seq"]
        bs = specs["tokens"].spec[0]
        noise = M.CFMNoise(
            t=_placed_input(Input((B,), F32, Spec(bs)), mesh, device),
            x0=_placed_input(Input((B, S, cfg.latent_dim), F32, Spec(bs, None, None)),
                             mesh, device),
            drop=_placed_input(Input((B,), torch.bool, Spec(bs)), mesh, device))
        return cfg, build_step(cfg, "train", mesh), (params, opt, batch, noise)
    if kind == "prefill":
        batch = {k: _placed_input(v, mesh, device) for k, v in specs.items()}
        return cfg, build_step(cfg, "prefill", mesh), (params, batch)
    state = tree_map_with_path(lambda _, inp: _placed_input(inp, mesh, device), specs["state"])
    return cfg, build_step(cfg, "decode", mesh, window=specs["window"]), (
        params, _placed_input(specs["token"], mesh, device), state)


def local_bytes(tree) -> int:
    """The bytes of the storages that ``tree``'s leaves' local shards hold
    (each storage once)."""
    return sum(_local_storages(tree).values())


def trace_combo(arch: str, shape, mesh, *, device="cuda", smoke: bool = False) -> dict:
    """Trace one combo on ``mesh`` (a ``DeviceMesh`` over a running group,
    usually the fake one) and return its record's measured keys."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.analysis.counter import CostCounter
    from repro_torch.serving import sharded

    if torch.device(device).type == "cuda" and torch.version.cuda is None:
        raise RuntimeError("fake cuda tensors need a torch built with CUDA (Python's "
                           "indexing and autograd take a device guard of the tensor's "
                           "device); this one is CPU-only: trace with --device cpu")
    fake = FakeTensorMode(allow_non_fake_inputs=True)
    with fake:
        cfg, step, args = placed_inputs(arch, shape, mesh, device=device, smoke=smoke)
        arg_storages = _local_storages(list(args))
        t0 = time.perf_counter()
        with sharded.scope(mesh), CostCounter(fake) as counter:
            out = step(*args)
        lower_s = time.perf_counter() - t0
    cost = counter.result()
    output_bytes = sum(n for k, n in _local_storages(out).items() if k not in arg_storages)
    argument_bytes = sum(arg_storages.values())
    return {
        "lower_s": round(lower_s, 1),
        "devices": int(mesh.size()),
        "memory": {"argument_size_in_bytes": int(argument_bytes),
                   "output_size_in_bytes": int(output_bytes),
                   "temp_size_in_bytes": int(max(cost["peak_bytes"] - output_bytes, 0)),
                   "peak_size_in_bytes": int(argument_bytes + cost["peak_bytes"])},
        "flops": cost["flops"],
        "bytes": cost["bytes"],
        "collectives": cost["collectives"],
        "kernels": cost["kernels"],
        "param_count": int(cfg.param_count()),
        "active_param_count": int(active_param_count(cfg)),
    }


def start_fake_world(world: int) -> None:
    """A fake process group of ``world`` ranks in this process, as rank 0.
    Refuses to start beside a running group (a real one would be reused
    by the meshes, as XLA's device count is fixed at its first use)."""
    if dist.is_initialized():
        raise RuntimeError("the dry run starts its own fake process group of 256 or 512 "
                           "ranks and refuses to run beside the running one (world size "
                           f"{dist.get_world_size()}): run it in a process of its own")
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def stop_world() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def reckon_host(arch: str, shape, *, device="cuda", smoke: bool = False) -> dict:
    """One combo on the 1 x 1 mesh of a fake world of one rank, started and
    stopped here (``shape``: a key of ``SHAPES`` or a dict of that form):
    what the unsharded step holds and computes on one card."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.mesh import AXES

    start_fake_world(1)
    try:
        mesh = init_device_mesh(torch.device(device).type, (1, 1), mesh_dim_names=AXES)
        context.install(mesh)
        try:
            return trace_combo(arch, shape, mesh, device=device, smoke=smoke)
        finally:
            context.clear()
    finally:
        stop_world()


def run_combo(arch: str, shape: str, multi_pod: bool, outdir: str, *,
              q_chunk: int = 0, tag: str = "", device="cuda", smoke: bool = False) -> dict:
    """One combo on the production mesh of the running fake group; writes
    and returns its record."""
    mesh_name = ("pod2x16x16" if multi_pod else "pod16x16") + (f"-{tag}" if tag else "")
    reason = skip_reason(arch, shape)
    rec = {"arch": arch, "shape": shape, "mesh": mesh_name}
    if reason:
        rec.update(status="skipped", reason=reason)
        return rec
    mesh = make_production_mesh(multi_pod=multi_pod, device=device)
    context.install(mesh, q_chunk=q_chunk)
    try:
        rec.update(status="ok", **trace_combo(arch, shape, mesh, device=device, smoke=smoke))
    finally:
        context.clear()
    os.makedirs(outdir, exist_ok=True)
    with open(os.path.join(outdir, f"{arch}__{shape}__{mesh_name}.json"), "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--single-pod", action="store_true")
    ap.add_argument("--outdir", default="experiments/dryrun")
    ap.add_argument("--seq-par-attn", action="store_true",
                    help="refused: the port has no sequence-parallel attention")
    ap.add_argument("--q-chunk", type=int, default=0)
    ap.add_argument("--flash", action="store_true",
                    help="refused: --device picks the attention path (cuda: the "
                         "flash kernel)")
    ap.add_argument("--tag", default="")
    ap.add_argument("--device", default="cuda",
                    help="cuda: fake tensors on the card's paths (the kernels' "
                         "launchers); cpu: the plain paths")
    ap.add_argument("--smoke", action="store_true", help="the archs' smoke configs")
    ap.add_argument("--jobs", type=int, default=1,
                    help="run each combo in a process of its own, this many at once "
                         "(each starts its own fake group; the logs go to <outdir>/logs)")
    args = ap.parse_args(argv)
    if args.seq_par_attn:
        ap.error("--seq-par-attn: the port's attention splits heads, never positions; "
                 "a record under this policy would describe another step")
    if args.flash:
        ap.error("--flash: --device cuda already attends through the flash kernel "
                 "and --device cpu through the plain path")

    archs = [args.arch] if args.arch else list(ARCHS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = []
    if args.single_pod or not args.multi_pod:
        meshes.append(False)
    if args.multi_pod or args.all:
        meshes.append(True)

    if args.jobs > 1:
        combos = [(mp, a, s) for mp in meshes for a in archs for s in shapes]
        failures = _run_in_processes(combos, args, argv)
        if failures:
            raise SystemExit(f"{failures} combos failed")
        return

    failures = 0
    for mp in meshes:
        start_fake_world(512 if mp else 256)
        try:
            for arch in archs:
                for shape in shapes:
                    try:
                        rec = run_combo(arch, shape, mp, args.outdir,
                                        q_chunk=args.q_chunk, tag=args.tag, device=args.device,
                                        smoke=args.smoke)
                        status = rec["status"]
                        if status == "ok":
                            mem = rec["memory"]
                            extra = (f"trace={rec['lower_s']}s flops={rec['flops']:.3g} "
                                     f"peak={mem['peak_size_in_bytes'] / 2 ** 30:.2f}GiB "
                                     f"coll={_collective_bytes(rec) / 1e9:.3g}GB")
                        else:
                            extra = rec.get("reason", "")
                        print(f"[{status:7s}] {arch} x {shape} x "
                              f"{'multi' if mp else 'single'}: {extra}", flush=True)
                    except Exception as e:
                        failures += 1
                        print(f"[FAIL   ] {arch} x {shape} x "
                              f"{'multi' if mp else 'single'}: {e}", flush=True)
                        traceback.print_exc()
        finally:
            stop_world()
    if failures:
        raise SystemExit(f"{failures} combos failed")


def _run_in_processes(combos: list, args, argv) -> int:
    """``--jobs N``: each combo in ``python -m repro_torch.launch.dryrun``
    of its own, N at a time; their status lines in order. Returns the
    failures."""
    import subprocess
    import sys
    from concurrent.futures import ThreadPoolExecutor

    logs = os.path.join(args.outdir, "logs")
    os.makedirs(logs, exist_ok=True)
    keep = []
    skip_next = False
    for a in (argv if argv is not None else sys.argv[1:]):
        if skip_next:
            skip_next = False
        elif a in ("--arch", "--shape", "--jobs"):
            skip_next = True
        elif a not in ("--all", "--multi-pod", "--single-pod") and not a.startswith(
                ("--arch=", "--shape=", "--jobs=")):
            keep.append(a)

    def one(combo):
        mp, arch, shape = combo
        log = os.path.join(logs, f"{arch}__{shape}__{'multi' if mp else 'single'}.log")
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape",
               shape, "--multi-pod" if mp else "--single-pod", *keep]
        with open(log, "w") as f:
            rc = subprocess.run(cmd, stdout=f, stderr=subprocess.STDOUT).returncode
        with open(log) as f:
            status = [line.rstrip() for line in f if line.startswith("[")]
        return rc, (status[-1] if status else f"[FAIL   ] {arch} x {shape}: exit {rc}, "
                    f"see {log}")

    failures = 0
    with ThreadPoolExecutor(args.jobs) as pool:
        for rc, line in pool.map(one, combos):
            failures += rc != 0
            print(line, flush=True)
    return failures


def _collective_bytes(rec: dict) -> float:
    return sum(v for k, v in rec["collectives"].items() if not k.endswith("_count"))


if __name__ == "__main__":
    main()
