"""Serving launcher: flow sampling with an NS solver, or autoregressive decode.

Port of ``repro.launch.serve``:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --mode flow \
      --full --nfe 8 --batch 4 --seq 1024 --requests 3 --bns-iters 0
  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --mode flow \
      --full --nfe 8 --batch 4 --seq 1024 --requests 2 --bns-iters 8 \
      --solver-artifact solver.msgpack
  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --mode flow \
      --full --budgets 4,8 --request-budgets 4,8,16 --batch 4 --seq 256 \
      --requests 3 --bns-iters 4 --solver-artifact anytime.msgpack
  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --mode decode \
      --full --gateway --page-size 16 --paged-kernel --max-slots 8 --slots 256 \
      --requests 16 --decode-lengths 128,32,64,16 --prefill-chunk 64
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b --mode flow \
      --full --nfe 8 --batch 4 --seq 1024 --requests 3 --bns-iters 0
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b --mode decode \
      --full --gateway --max-slots 4 --requests 8 --decode-lengths 32,16

``--arch`` takes yi-6b (dense) or rwkv6-7b (ssm: its flow forward runs the
gla_scan kernel, its decode steps the recurrence in plain torch).

Runs on the card by default (``--device cuda``, an error without one);
``--device cpu`` runs the plain CPU path. Weights are random, drawn from a
``torch.Generator`` seeded with ``--seed``; conditioning tokens come from
``SyntheticTokens``.

Flow mode acquires its solver through a ``SolverZoo``, as the reference's
does: an existing ``--solver-artifact`` file (or anything ``--zoo-dir``
indexes for the requested spec) is loaded without retraining; a miss
distils the spec ``_requested_spec`` names (euler at ``--nfe``, BNS mode;
or, with ``--budgets``, one anytime solver over those budgets) with
``--bns-iters N`` > 0 (``_distill_artifact``: RK45 pairs from two seeded
generators, then ``SolverSpec.distill`` on a field that recomputes each
layer in the backward), saves the artifact (at ``--solver-artifact``, else
in a temporary directory) and serves the reloaded copy. ``--bns-iters 0``
serves the initial solver without an artifact. An anytime artifact routes
each request (``--request-budgets``, cycled) to its early exit; a budget the
solver does not serve goes to the nearest one with a WARNING, or exits under
``--strict-nfe``. rwkv6-7b does not distil on the card yet (its
``gla_scan`` kernel has no backward; the CPU runs). The flow gateway tiers
exit with the ROADMAP item that brings them, as do the reference's
``--continuous``, ``--tiers``, ``--max-batch``, ``--max-wait-ms`` and
``--mixed-budget-policy`` (item 7), ``--mesh`` and ``--fleet`` (item 8),
``--ckpt`` and ``--profile`` (item 11) when set off their defaults — the
launcher never serves something else in their place. ``--kernel-update`` is
accepted and changes nothing: the card always runs the ``ns_update``
kernel. A loaded ``--solver-artifact`` of any single-budget kind serves
through ``FlowSampler.from_artifact`` (a baseline ``ns`` artifact of ddim,
dpm2m or edm_heun included), an anytime one through
``AnytimeFlowSampler.from_artifact``. Each request prints its shape, its NFE and
its wall time, read after the device has finished; the run ends with the
zoo's counts.

Decode mode serves batched greedy decode (``greedy_demo``) or, with
``--gateway``, a continuous-batching ``DecodeGateway``: each request is one
prompt ``[(3r+1) % vocab, (5r+2) % vocab]`` submitted to a pool of
``--max-slots`` state slots, ``--decode-lengths`` cycling its max_tokens.
``--page-size`` pages the KV cache (a no-op for rwkv6-7b, whose recurrent
state is O(1) a slot), ``--paged-kernel`` attends through the
paged-attention kernel, ``--prefill-chunk`` sets the chunked prefill width
(0 = token by token), ``--temperature``/``--top-k``/``--top-p`` sample
instead of greedy, ``--stream`` submits through ``submit_stream``, and
``--slo``/``--deadline-ms``/``--priority`` attach an ``SLOConfig``. The
telemetry flags exit naming their ROADMAP item. ``main`` returns what the
run served: the flow mode's ``FlowServed`` list, ``GreedyDecoded``, or
``DecodeServed`` (the responses and the gateway's ``stats()``).
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import os
import tempfile
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.core import ns_solver
from repro_torch.core.anytime import evaluate_anytime, init_anytime
from repro_torch.core.bns import BNSTrainConfig, psnr
from repro_torch.core.rk45 import rk45_solve
from repro_torch.core.schedulers import get_scheduler
from repro_torch.data.synthetic import DataConfig, SyntheticTokens
from repro_torch.kernels.gla_scan.ops import BACKWARD_ROADMAP as GLA_BACKWARD_ROADMAP
from repro_torch.models import model as M
from repro_torch.observability import format_stats_line
from repro_torch.serving.decode import DecodeGateway, DecodeRequest
from repro_torch.serving.engine import (
    AnytimeFlowSampler,
    DecodeEngine,
    FlowSampler,
    SamplingParams,
    greedy_demo,
)
from repro_torch.serving.slo import AdmissionRejected, DeadlineExceeded, SLOConfig
from repro_torch.serving.zoo import SolverZoo
from repro_torch.solvers import SolverArtifact, SolverSpec

DEFAULT_NFE = 8

# The reference launcher's flow --gateway, not served by the port yet.
_FLOW_GATEWAY = ("the flow gateway tiers (ROADMAP Queue A item 7); decode mode "
                 "serves --gateway")
# The reference's flags for what the port does not serve yet: dest -> (flag,
# what it selects, the ROADMAP Queue A item that brings it, the reference's
# add_argument keywords). A value off that default exits naming the item.
_UNPORTED = {
    "continuous": ("--continuous", "the continuous flow gateway", 7,
                   dict(action="store_true", default=False)),
    "tiers": ("--tiers", "the flow gateway's shape tiers", 7, dict(default=None)),
    "max_batch": ("--max-batch", "the flow gateway's coalescing", 7,
                  dict(type=int, default=8)),
    "max_wait_ms": ("--max-wait-ms", "the flow gateway's coalescing", 7,
                    dict(type=float, default=10.0)),
    "mixed_budget_policy": ("--mixed-budget-policy", "the flow gateway's "
                            "multi-budget routing", 7,
                            dict(default="auto", choices=["never", "auto", "always"])),
    "mesh": ("--mesh", "backbone sharding over a serving mesh", 8,
             dict(default="none", choices=["none", "host", "production", "multipod"])),
    "fleet": ("--fleet", "the fleet gateway", 8, dict(type=int, default=1)),
    "ckpt": ("--ckpt", "restoring backbone weights from a checkpoint", 11,
             dict(default=None)),
    "profile": ("--profile", "the launch profiles", 11,
                dict(default="default", choices=["default", "tuned"])),
    **{dest: (flag, "the telemetry surfaces", 11, dict(default=None)) for dest, flag in (
        ("metrics_port", "--metrics-port"), ("metrics_json", "--metrics-json"),
        ("stats_interval", "--stats-interval"), ("trace_jsonl", "--trace-jsonl"))},
}


@dataclasses.dataclass
class Served:
    """One answered request."""

    latents: torch.Tensor     # (B, S, latent_dim) f32
    tokens: torch.Tensor      # (B, S) long
    nfe: int
    ms: float                 # wall time, device work included


@dataclasses.dataclass
class Distillation:
    """What a miss distilled before serving (``--bns-iters`` > 0)."""

    rk45: dict                # {"train"|"val": (nfe, accepted, rejected)}
    rk45_seconds: float       # both RK45 solves, device work included
    init_val_psnr: float      # the initial solver on the val pairs, dB (anytime:
    #                           the mean over budgets)
    init_val_seconds: float   # that one validation sample
    val_psnr: float           # the distilled (best-validation) solver, dB
    iterations: int
    train_seconds: float      # SolverSpec.distill, device work included
    iteration_seconds: list   # each training iteration's (bns.fit's)
    num_parameters: int
    history: list             # (iter, train_loss, val_psnr)
    params: object            # the distilled BNSParams or AnytimeParams, as saved
    solver: object            # the distilled NSParams (AnytimeParams for anytime)


class FlowServed(list):
    """The flow mode's ``Served`` list, and how its solver was acquired:
    ``distillation`` where a miss distilled it, ``zoo`` the zoo's counts
    (``ZooStats``), ``artifact`` the served ``SolverArtifact`` and
    ``sampler`` the serving session."""

    distillation: Distillation | None = None
    zoo = None
    artifact = None
    sampler = None


@dataclasses.dataclass
class GreedyDecoded:
    """The decode demo's batch (decode mode without ``--gateway``)."""

    tokens: torch.Tensor      # (batch, steps) int32, on the host
    ms_per_token: float       # wall time, device work included


@dataclasses.dataclass
class DecodeServed:
    """What the decode gateway served: one response per request (None where
    admission rejected or the deadline shed it) and its final snapshots."""

    responses: list
    stats: dict               # DecodeGateway.stats()
    metrics: dict             # DecodeGateway.metrics_snapshot()
    wall_s: float             # submit of the first request to the end of drain


def _int_list(text: str) -> tuple[int, ...]:
    try:
        vals = tuple(int(tok) for tok in text.split(",") if tok.strip())
    except ValueError:
        raise argparse.ArgumentTypeError(f"bad list {text!r}")
    if not vals or any(v < 1 for v in vals):
        raise argparse.ArgumentTypeError(f"bad list {text!r}")
    return vals


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--mode", choices=["flow", "decode"], default="flow")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--scheduler", default="fm_ot")
    ap.add_argument("--nfe", type=int, default=None,
                    help=f"solver NFE (default {DEFAULT_NFE})")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=16)
    ap.add_argument("--requests", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cfg-scale", type=float, default=0.0)
    ap.add_argument("--bns-iters", type=int, default=300,
                    help="BNS distillation iterations before serving (0 = serve "
                         "the initial euler solver)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--solver-artifact", default=None,
                    help="load the solver from this artifact if it exists; "
                         "otherwise distill and save it here")
    ap.add_argument("--budgets", type=_int_list, default=None,
                    help="serve an anytime solver at these NFE budgets, e.g. 4,8,16 "
                         "(one shared artifact, per-request budget routing)")
    ap.add_argument("--request-budgets", type=_int_list, default=None,
                    help="per-request NFE budgets, cycled over --requests "
                         "(default: cycle the artifact's budgets)")
    ap.add_argument("--strict-nfe", action="store_true",
                    help="reject budgets the artifact does not serve instead of "
                         "routing to the nearest one")
    ap.add_argument("--zoo-dir", default=None,
                    help="scan this directory for saved solver artifacts")
    ap.add_argument("--zoo-capacity", type=int, default=4)
    ap.add_argument("--gateway", action="store_true",
                    help="decode: serve through the continuous-batching "
                         "DecodeGateway; flow: not served yet, " + _FLOW_GATEWAY)
    # decode mode, as the reference's flags
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--slots", type=int, default=128,
                    help="decode: KV cache positions per slot")
    ap.add_argument("--window", type=int, default=0,
                    help="decode: sliding-window ring buffer (0 = full cache)")
    ap.add_argument("--max-slots", type=int, default=8,
                    help="decode gateway: sequence slot count")
    ap.add_argument("--decode-lengths", type=_int_list, default=None,
                    help="decode gateway: per-request max_tokens, cycled over "
                         "--requests (default: --steps and --steps/2)")
    ap.add_argument("--page-size", type=int, default=0,
                    help="decode: paged KV cache page size in tokens (0 = dense "
                         "per-slot cache); must divide --slots")
    ap.add_argument("--paged-kernel", action="store_true",
                    help="decode: attend over the paged cache through the CUDA "
                         "paged-attention kernel (its plain version on the CPU)")
    ap.add_argument("--prefill-chunk", type=int, default=64,
                    help="decode gateway: batched prefill chunk width in tokens "
                         "(0 = token-by-token teacher forcing)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="decode gateway: sampling temperature (0 = greedy)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="decode gateway: keep the k most likely tokens (0 = all)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="decode gateway: nucleus threshold (1.0 = no cap)")
    ap.add_argument("--stream", action="store_true",
                    help="decode gateway: submit via submit_stream and report "
                         "the streamed tokens")
    ap.add_argument("--slo", action="store_true",
                    help="decode gateway: attach an SLOConfig (fast-reject "
                         "admission, deadline shedding, urgency order)")
    ap.add_argument("--slo-slack", type=float, default=0.0,
                    help="with --slo: margin in ms taken off every deadline")
    ap.add_argument("--slo-default-cost-ms", type=float, default=0.0,
                    help="with --slo: per-dispatch cost before the first "
                         "dispatch is observed")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="decode gateway: per-request deadline in ms from submit")
    ap.add_argument("--priority", type=int, default=0,
                    help="decode gateway: request priority (higher first under --slo)")
    ap.add_argument("--kernel-update", action="store_true",
                    help="accepted for the reference's CLI; the port always runs "
                         "the ns_update kernel on the card")
    for dest, (flag, what, item, kw) in _UNPORTED.items():
        ap.add_argument(flag, dest=dest, **kw,
                        help=f"not served yet: {what} (ROADMAP Queue A item {item})")
    return ap


def _refuse_unported(args) -> None:
    if args.mode == "flow":
        loads = bool(args.solver_artifact) and os.path.exists(args.solver_artifact)
        if (args.bns_iters > 0 and args.device == "cuda" and not loads
                and get_config(args.arch, smoke=args.smoke).family == "ssm"):
            raise SystemExit(
                f"not served by the port yet: BNS distillation of {args.arch} on the "
                f"card: its gla_scan kernel has no backward ({GLA_BACKWARD_ROADMAP}); "
                "--device cpu distills through the plain chunked form, --bns-iters 0 "
                "serves the initial euler solver")
        if args.gateway:
            raise SystemExit(f"not served by the port yet: {_FLOW_GATEWAY}")
    for dest, (flag, what, item, kw) in _UNPORTED.items():
        if getattr(args, dest) != kw["default"]:
            raise SystemExit(f"not served by the port yet: {flag}, {what} "
                             f"(ROADMAP Queue A item {item})")


def _requested_spec(args) -> SolverSpec:
    """The solver the CLI asks for: anytime over --budgets, else fixed-NFE BNS."""
    if args.budgets:
        return SolverSpec(name="midpoint", mode="anytime",
                          budgets=args.budgets, cfg_scale=args.cfg_scale)
    return SolverSpec(name="euler", nfe=args.nfe or DEFAULT_NFE,
                      cfg_scale=args.cfg_scale, mode="bns")


def _initial_artifact(spec: SolverSpec, field) -> SolverArtifact:
    """``--bns-iters 0``: the spec's initial solver for ``field``, in memory
    (no file): euler at the spec's NFE, or the nested-grid anytime solver."""
    if spec.mode == "anytime":
        return SolverArtifact(spec=spec, params=init_anytime(field, spec.budgets),
                              val_psnr=math.nan)
    return SolverArtifact(spec=dataclasses.replace(spec, mode="baseline"),
                          params=spec.build(field), val_psnr=math.nan)


def _distill_artifact(args, params, cfg, sched, cond, spec: SolverSpec,
                      device: torch.device) -> tuple[Distillation, SolverArtifact]:
    """Algorithm 2 on fresh RK45 pairs, as the reference's
    ``_distill_artifact``; returns the record and the saved-and-reloaded
    artifact. Train and held-out val x0 of (batch, seq, latent_dim) from two
    generators seeded from ``--seed``, each integrated by RK45 (rtol = atol =
    1e-5) under no_grad; the initial solver's val PSNR; then
    ``spec.distill`` (lr 1e-3, cosine, ``--bns-iters`` iterations, validation
    every 100 and at the end, full batches), differentiating a field that
    recomputes each layer in the backward."""
    anytime = spec.mode == "anytime"
    what = (f"anytime solver (budgets={spec.budgets})" if anytime
            else f"BNS solver (NFE={spec.nfe})")
    print(f"distilling {what} ...")
    field = M.velocity_field(params, cfg, sched, cond, cfg_scale=args.cfg_scale,
                             remat=True)
    shape = (args.batch, args.seq, cfg.latent_dim)
    pairs, rk45 = {}, {}
    t0 = time.perf_counter()
    for i, part in enumerate(("train", "val")):
        gen = torch.Generator(device=device).manual_seed(args.seed + 1 + i)
        x0 = torch.randn(shape, generator=gen, device=device)
        with torch.no_grad():
            res = rk45_solve(field.fn, x0, rtol=1e-5, atol=1e-5)
        pairs[part] = (x0, res.x1)
        rk45[part] = (res.nfe, res.accepted, res.rejected)
    _sync(device)
    rk45_s = time.perf_counter() - t0
    print(f"RK45 pairs: train nfe {rk45['train'][0]} (accepted {rk45['train'][1]}, "
          f"rejected {rk45['train'][2]}), val nfe {rk45['val'][0]} (accepted "
          f"{rk45['val'][1]}, rejected {rk45['val'][2]}), {rk45_s:.1f}s")
    t0 = time.perf_counter()
    x0v, x1v = pairs["val"]
    if anytime:
        scores = evaluate_anytime(init_anytime(None, spec.budgets), spec.budgets, field,
                                  pairs["val"])
        init_psnr = sum(scores.values()) / len(scores)
    else:
        with torch.no_grad():
            init_psnr = float(torch.mean(psnr(
                ns_solver.ns_sample(spec.build(field), field.fn, x0v), x1v)))
    _sync(device)
    init_s = time.perf_counter() - t0
    print(f"initial {'anytime (nested grid)' if anytime else spec.name} solver: "
          f"{'mean ' if anytime else ''}val PSNR {init_psnr:.2f} dB")
    t0 = time.perf_counter()
    res = spec.distill(field, pairs["train"], pairs["val"],
                       BNSTrainConfig(lr=1e-3, lr_schedule="cosine",
                                      iterations=args.bns_iters, val_every=100,
                                      batch_size=args.batch), log=print)
    _sync(device)
    train_s = time.perf_counter() - t0
    print(f"solver ready: {res.num_parameters} params, val PSNR {res.val_psnr:.2f} dB, "
          f"{res.wall_seconds:.0f}s")
    path = args.solver_artifact or os.path.join(
        tempfile.mkdtemp(prefix="bns_solver_"), "solver.msgpack")
    res.artifact(provenance={"arch": args.arch, "scheduler": args.scheduler,
                             "seed": args.seed, "bns_iters": args.bns_iters}).save(path)
    print(f"solver artifact saved to {path}")
    record = Distillation(
        rk45=rk45, rk45_seconds=rk45_s, init_val_psnr=init_psnr,
        init_val_seconds=init_s, val_psnr=res.val_psnr, iterations=args.bns_iters,
        train_seconds=train_s, iteration_seconds=res.iteration_seconds,
        num_parameters=res.num_parameters, history=res.history, params=res.params,
        solver=res.params if anytime else ns_solver.materialize(res.params))
    return record, SolverArtifact.load(path)


def _resolve_budget(artifact: SolverArtifact, nfe: int, strict: bool, warned: set) -> int:
    """Route a requested NFE to a budget the artifact serves: an exact match
    passes through; otherwise --strict-nfe exits, and the default picks the
    nearest served budget with one WARNING per distinct mismatch."""
    if nfe in artifact.budgets:
        return nfe
    if strict:
        raise SystemExit(f"--strict-nfe: requested NFE {nfe} but the "
                         f"artifact serves {artifact.budgets}")
    near = artifact.nearest_budget(nfe)
    if nfe not in warned:
        warned.add(nfe)
        print(f"WARNING: requested NFE {nfe} not served by the artifact "
              f"(budgets {artifact.budgets}); using nearest budget {near}")
    return near


def _load_artifact(args, zoo: SolverZoo) -> SolverArtifact:
    """The existing ``--solver-artifact`` file, through the zoo (a load)."""
    artifact = zoo.load(args.solver_artifact)
    print(f"loaded solver artifact {args.solver_artifact}: "
          f"{artifact.spec.mode}/{artifact.spec.name} budgets={artifact.budgets}, "
          f"val PSNR {artifact.val_psnr:.2f} dB (no retraining)")
    for key, want in [("arch", args.arch), ("scheduler", args.scheduler)]:
        have = artifact.provenance.get(key)
        if have is not None and have != want:
            print(f"WARNING: artifact was distilled for {key}={have!r} "
                  f"but serving {key}={want!r} — samples will be degraded")
    if args.budgets and tuple(sorted(args.budgets)) != artifact.budgets:
        print(f"WARNING: --budgets {','.join(map(str, args.budgets))} "
              f"ignored; the loaded artifact serves {artifact.budgets}")
    return artifact


def serve_flow(args, device: torch.device) -> FlowServed:
    cfg = get_config(args.arch, smoke=args.smoke)
    sched = get_scheduler(args.scheduler)
    params = M.init_params(torch.Generator(device=device).manual_seed(args.seed),
                           cfg, device)
    data = SyntheticTokens(cfg, DataConfig(batch_size=args.batch,
                                           seq_len=args.seq, seed=args.seed),
                           device=device)
    cond = data.batch(0)
    served = FlowServed()

    def distill(spec: SolverSpec) -> SolverArtifact:
        served.distillation, artifact = _distill_artifact(args, params, cfg, sched, cond,
                                                          spec, device)
        return artifact

    scan_dirs = [d for d in (args.zoo_dir, os.path.dirname(args.solver_artifact)
                             if args.solver_artifact else None) if d]
    zoo = SolverZoo(capacity=args.zoo_capacity,
                    distill_fn=distill if args.bns_iters > 0 else None,
                    scan_dirs=scan_dirs)
    spec = _requested_spec(args)
    if args.solver_artifact and os.path.exists(args.solver_artifact):
        artifact = _load_artifact(args, zoo)
    else:
        try:
            artifact = zoo.get(spec, log=print)
        except KeyError:            # --bns-iters 0 and no saved solver for the spec
            if args.bns_iters > 0:
                raise
            artifact = _initial_artifact(spec, M.velocity_field(
                params, cfg, sched, cond, cfg_scale=args.cfg_scale))
            what = (f"anytime solver at budgets {spec.budgets}" if spec.budgets
                    else f"euler solver at NFE {spec.nfe}")
            print(f"serving the initial {what} (no distillation)")
    if served.distillation is not None:
        print(f"serving the distilled {'anytime' if spec.budgets else 'BNS'} solver at "
              + (f"budgets {spec.budgets}" if spec.budgets else f"NFE {spec.nfe}"))
    anytime = artifact.kind == "anytime"
    if anytime:
        sampler = AnytimeFlowSampler.from_artifact(artifact, params=params, cfg=cfg,
                                                   sched=sched)
    else:
        sampler = FlowSampler.from_artifact(artifact, params=params, cfg=cfg, sched=sched)
    served.artifact, served.sampler = artifact, sampler
    if args.request_budgets:
        request_budgets = args.request_budgets
    elif args.nfe is not None:
        # an explicit --nfe is a request, never silently ignored
        request_budgets = (args.nfe,)
    else:
        request_budgets = artifact.budgets
    warned: set = set()
    for req in range(args.requests):
        nfe = _resolve_budget(artifact, request_budgets[req % len(request_budgets)],
                              args.strict_nfe, warned)
        _sync(device)
        t0 = time.perf_counter()
        gen = torch.Generator(device=device).manual_seed(1000 + req)
        latents = (sampler.sample(cond, gen, budget=nfe) if anytime
                   else sampler.sample(cond, gen))
        tokens = sampler.nearest_tokens(latents)
        _sync(device)
        ms = (time.perf_counter() - t0) * 1e3
        print(f"request {req}: sampled {tuple(tokens.shape)} in {ms:.1f} ms "
              f"({nfe} NFE)")
        served.append(Served(latents=latents, tokens=tokens, nfe=nfe, ms=ms))
    served.zoo = zoo.stats
    print(f"zoo stats: hits={served.zoo.hits} misses={served.zoo.misses} "
          f"loads={served.zoo.loads} distills={served.zoo.distills}")
    return served


def serve_decode(args, device: torch.device):
    cfg = get_config(args.arch, smoke=args.smoke)
    params = M.init_params(torch.Generator(device=device).manual_seed(args.seed),
                           cfg, device)
    engine = DecodeEngine(params=params, cfg=cfg, window=args.window,
                          page_size=args.page_size, paged_kernel=args.paged_kernel)
    if args.gateway:
        return _serve_decode_gateway(args, engine, cfg)
    tokens, dt = greedy_demo(engine, args.batch, args.steps, args.slots)
    print(f"decoded {args.steps} tokens x {args.batch} seqs ({dt:.1f} ms/token); "
          f"first row: {tokens[0, :8].tolist()}")
    return GreedyDecoded(tokens=tokens, ms_per_token=dt)


def _serve_decode_gateway(args, engine: DecodeEngine, cfg) -> DecodeServed:
    """Continuous decode batching: every request is one prompt -> state slot."""
    lengths = args.decode_lengths or (args.steps, max(1, args.steps // 2))
    sampling = None
    if args.temperature > 0.0 or args.top_k > 0 or args.top_p < 1.0:
        sampling = SamplingParams(temperature=args.temperature, top_k=args.top_k,
                                  top_p=args.top_p)
    slo = (SLOConfig(slack_ms=args.slo_slack, default_cost_ms=args.slo_default_cost_ms)
           if args.slo else None)
    gw = DecodeGateway(engine, max_slots=args.max_slots, cache_slots=args.slots,
                       prefill_chunk=args.prefill_chunk, seed=args.seed, slo=slo)
    t0 = time.perf_counter()
    gw.start()
    futures = []
    for req in range(args.requests):
        prompt = [(3 * req + 1) % cfg.vocab, (5 * req + 2) % cfg.vocab]
        kw = dict(prompt=prompt, max_tokens=lengths[req % len(lengths)],
                  sampling=sampling, deadline_ms=args.deadline_ms, priority=args.priority)
        try:
            futures.append(gw.submit_stream(**kw) if args.stream
                           else gw.submit(DecodeRequest(**kw)))
        except AdmissionRejected as e:
            print(f"request {req}: REJECTED at admission ({e})")
            futures.append(None)
    gw.shutdown()
    wall = time.perf_counter() - t0
    responses = []
    for i, fut in enumerate(futures):
        if fut is None:
            responses.append(None)
            continue
        try:
            streamed = 0
            if args.stream:
                chunks = fut.chunks(timeout=60.0)
                streamed = sum(1 for c in chunks if not c.final)
                response = chunks[-1].payload
            else:
                response = fut.result()     # an engine failure re-raises here
        except DeadlineExceeded:
            print(f"request {i}: SHED (deadline exceeded in queue)")
            responses.append(None)
            continue
        meta = response.meta
        print(f"request {i}: {meta['new_tokens']} tokens ({meta['finish_reason']}), "
              f"wait {meta['wait_ms']:.1f} ms, slot {meta['slot']}, "
              f"join_step {meta['join_step']}"
              + (f", {streamed} streamed tokens" if args.stream else ""))
        responses.append(response)
    stats = gw.stats()
    print(format_stats_line(stats, prefix="decode gateway stats"))
    return DecodeServed(responses=responses, stats=stats,
                        metrics=gw.metrics_snapshot(), wall_s=wall)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    args = build_parser().parse_args(argv)
    _refuse_unported(args)
    if args.kernel_update:
        print("--kernel-update: a no-op in the port, which always runs its ns_update "
              "kernel on the card (its plain version on the CPU)")
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(str(e)) from None
    return (serve_flow if args.mode == "flow" else serve_decode)(args, device)


if __name__ == "__main__":
    main()
