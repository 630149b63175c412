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
  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --mode flow \
      --full --solver-artifact anytime.msgpack --gateway --max-batch 4 \
      --max-wait-ms 60000 --request-budgets 4,8 --requests 12 --batch 4 \
      --seq 1024 --bns-iters 0 [--continuous --max-slots 4] [--tiers 512,1024]
  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --mode decode \
      --full --gateway --page-size 16 --paged-kernel --max-slots 8 --slots 256 \
      --requests 16 --decode-lengths 128,32,64,16 --prefill-chunk 64
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b --mode flow \
      --full --nfe 8 --batch 4 --seq 1024 --requests 3 --bns-iters 0
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b --mode decode \
      --full --gateway --max-slots 4 --requests 8 --decode-lengths 32,16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b --mode flow \
      --full --nfe 8 --batch 4 --seq 1024 --requests 3 --bns-iters 0
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b --mode decode \
      --full --gateway --max-slots 4 --requests 8 --decode-lengths 32,16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-medium --mode flow \
      --full --nfe 8 --batch 4 --seq 1024 --requests 3 --bns-iters 0
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-medium --mode decode \
      --full --batch 4 --steps 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch internvl2-26b --mode flow \
      --full --nfe 8 --batch 4 --seq 1024 --requests 2 --bns-iters 0
  PYTHONPATH=src python -m repro_torch.launch.serve --arch internvl2-26b --mode decode \
      --full --gateway --page-size 16 --paged-kernel --slots 256 --max-slots 4 \
      --requests 8 --decode-lengths 32,16

``--arch`` takes yi-6b, yi-34b, phi3-medium-14b and command-r-35b (dense;
command-r-35b's parallel block and tied embeddings), qwen3-moe-30b-a3b and
qwen3-moe-235b-a22b (moe: 128 experts, top 8, the router and expert products
in plain torch beside the flash and paged kernels), rwkv6-7b (ssm: its flow
forward runs the gla_scan kernel, its decode steps the recurrence in plain
torch) or zamba2-2.7b (hybrid: Mamba2 blocks and one weight-shared attention
block; its flow forward runs the gla_scan kernel in the inclusive mode and the
flash kernel at head dim 80, its decode steps the recurrence and a dense KV
cache a shared-attention site in plain torch), whisper-medium (encdec: the
encoder over the batch's stub audio frames runs inside every velocity call,
its self- and cross-attention through the flash kernel at head dim 64) or
internvl2-26b (vlm: the projected stub vision patches prepended to the dense
LM's sequence in flow; decode as the dense family, paged included). These
are the reference registry's ten archs.

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
``--strict-nfe``. rwkv6-7b, zamba2-2.7b and whisper-medium do not distil on
the card yet (the ``gla_scan`` kernel has no backward, nor has the flash
kernel at zamba2-2.7b's head dim 80 or whisper-medium's 64; the CPU runs).
Each RK45 solve's step runs as one program (``core/rk45.py::RK45Program``,
a CUDA graph on the card) that the train and val solves share. ``--kernel-update`` is
accepted and changes nothing: the card always runs the ``ns_update``
kernel. A loaded ``--solver-artifact`` of any single-budget kind serves
through ``FlowSampler.from_artifact`` (a baseline ``ns`` artifact of ddim,
dpm2m or edm_heun included), an anytime one through
``AnytimeFlowSampler.from_artifact``. Each request prints its shape, its NFE and
its wall time, read after the device has finished; the run ends with the
zoo's counts.

``--gateway`` serves the flow traffic through ``serving.Gateway``: each
request is a single-sample submit (token row ``req % --batch`` of the
conditioning batch, noise from ``Request.seed = 1000 + req``), coalesced by
resolved budget into padded buckets (``--max-batch``, ``--max-wait-ms``);
mixed-budget flushes may ride the anytime shared trajectory
(``--mixed-budget-policy``). ``--continuous`` admits requests into in-flight
anytime trajectories at exit boundaries instead (``ContinuousGateway``,
``--max-slots`` slots), ``--tiers`` pads each request's positions to a
shape-tier rung and crops the result back. Each response prints its
(requested, served) budget pair, wait and batch occupancy.

``--slo`` attaches an ``SLOConfig`` to either gateway mode (fast-reject
admission, deadline shedding, urgency order, and on the continuous tier
preemption at exit boundaries); ``--deadline-ms``/``--priority`` stamp each
request; ``--stream`` submits through ``submit_stream`` (per-exit-boundary
partials in flow, per-token chunks in decode). Every gateway mode shares the
telemetry flags: ``--metrics-port`` serves ``/metrics`` and
``/metrics.json`` on localhost while traffic runs, ``--stats-interval N``
prints a stats line every N seconds, ``--metrics-json`` writes the final
registry snapshot and ``--trace-jsonl`` the recorded request lifecycles.
``--fleet N`` federates N gateway hosts (each a ``Gateway``, or a
``ContinuousGateway`` under ``--continuous``, all serving the one sampler)
behind a ``FleetGateway``; the closing stats line adds the fleet's hosts,
steals and ``routed:`` counts. ``--mesh host`` places the sampler's weights
and each batch on the 1 x 1 mesh of this process (a process group of one
rank: NCCL on the card, gloo on the CPU), every gateway host on the same
mesh; ``production`` and ``multipod`` fall back to one device with a
WARNING where their 256 or 512 ranks are missing, as in the reference.
Both take the flow gateway only (``--gateway``). ``--ckpt PATH`` restores
the backbone's params from a checkpoint (``launch/train.py`` writes them, and
so does the reference's trainer) onto the launcher's device, in flow and
decode mode. ``--profile tuned`` re-executes the launcher once, before
anything touches the card, under the tuned launch profile
(``launch/profile.py``: allocator settings, tcmalloc where one is
installed); ``default`` changes nothing. A flow run on the card ends with
its peak device memory.

Decode mode serves batched greedy decode (``greedy_demo``; for
whisper-medium over a zeroed encoder memory of 1500 frames, as the
reference's) or, with ``--gateway``, a continuous-batching ``DecodeGateway``
(which refuses whisper-medium with TypeError, as the reference's does): each request is one
prompt ``[(3r+1) % vocab, (5r+2) % vocab]`` submitted to a pool of
``--max-slots`` state slots, ``--decode-lengths`` cycling its max_tokens.
``--page-size`` pages the KV cache (a no-op for rwkv6-7b, whose recurrent
state is O(1) a slot; refused for zamba2-2.7b, as in the reference), ``--paged-kernel`` attends through the
paged-attention kernel, ``--prefill-chunk`` sets the chunked prefill width
(0 = token by token), ``--temperature``/``--top-k``/``--top-p`` sample
instead of greedy. ``main`` returns what the run served: the flow mode's
``FlowServed`` list or ``GatewayServed``, ``GreedyDecoded``, or
``DecodeServed`` (the responses and the gateway's ``stats()``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import tempfile
import time

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import checkpointer
from repro_torch.configs import ARCHS, get_config
from repro_torch.core import ns_solver
from repro_torch.core.anytime import evaluate_anytime, init_anytime
from repro_torch.core.bns import BNSTrainConfig, psnr
from repro_torch.core.rk45 import RK45Program, rk45_solve
from repro_torch.core.schedulers import get_scheduler
from repro_torch.data.synthetic import DataConfig, SyntheticTokens
from repro_torch.launch.profile import maybe_reexec
from repro_torch.models import model as M
from repro_torch.observability import (
    MetricsServer,
    StatsPrinter,
    TraceRecorder,
    format_stats_line,
)
from repro_torch.serving.continuous import ContinuousGateway
from repro_torch.serving.decode import DecodeGateway, DecodeRequest
from repro_torch.serving.engine import (
    AnytimeFlowSampler,
    DecodeEngine,
    FlowSampler,
    SamplingParams,
    greedy_demo,
)
from repro_torch.serving.fleet import FleetGateway
from repro_torch.serving.gateway import Gateway, Request
from repro_torch.serving.sharded import serving_mesh
from repro_torch.serving.slo import AdmissionRejected, DeadlineExceeded, SLOConfig
from repro_torch.serving.tiers import ShapeLadder, TierOversize
from repro_torch.serving.zoo import SolverZoo
from repro_torch.solvers import SolverArtifact, SolverSpec

DEFAULT_NFE = 8

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
    rk45_programs: dict       # their one step program: captured, replays, capture ms
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
    programs: dict            # the training's programs (bns.fit's step and
    #                           validation): captured, replays, capture ms
    pairs: dict               # {"train"|"val": (x0, x1)}, on the device


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
    admission rejected or the deadline shed it), its final snapshots, and the
    engine that served them."""

    responses: list
    stats: dict               # DecodeGateway.stats()
    metrics: dict             # DecodeGateway.metrics_snapshot()
    wall_s: float             # submit of the first request to the end of drain
    engine: object = None


@dataclasses.dataclass
class GatewayServed:
    """What a flow gateway served: one response per request (None where
    admission rejected it or its deadline shed it), each request's streamed
    partials (0 without ``--stream``), the gateway's final snapshots, and
    how the solver was acquired (as ``FlowServed``)."""

    responses: list
    partials: list
    stats: dict               # Gateway.stats() after the drain
    metrics: dict             # Gateway.metrics_snapshot() after the drain
    wall_s: float             # submit of the first request to the end of drain
    zoo: object = None
    artifact: object = None
    sampler: object = None


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
    ap.add_argument("--arch", required=True,
                    help=f"the model: one of {', '.join(ARCHS)} (random weights)")
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
                    help="flow: serve the requests through the coalescing Gateway "
                         "(one single-sample submit each); decode: through the "
                         "continuous-batching DecodeGateway")
    ap.add_argument("--max-batch", type=int, default=8,
                    help="flow gateway: coalesce at most this many requests")
    ap.add_argument("--max-wait-ms", type=float, default=10.0,
                    help="flow gateway: flush partial batches after this wait")
    ap.add_argument("--continuous", action="store_true",
                    help="flow gateway: admit requests into in-flight anytime "
                         "trajectories at exit boundaries (ContinuousGateway; needs "
                         "an anytime artifact)")
    ap.add_argument("--tiers", default=None,
                    help="flow gateway: shape-tier rungs, e.g. 512,1024: each request "
                         "pads its positions to the smallest rung that holds it and "
                         "its result is cropped back; longer requests are rejected")
    ap.add_argument("--mixed-budget-policy", default="auto",
                    choices=["never", "auto", "always"],
                    help="flow gateway: route multi-budget flushes through the "
                         "anytime shared trajectory (never/auto/always)")
    # decode mode, as the reference's flags
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--slots", type=int, default=128,
                    help="decode: KV cache positions per slot")
    ap.add_argument("--window", type=int, default=0,
                    help="decode: sliding-window ring buffer (0 = full cache)")
    ap.add_argument("--max-slots", type=int, default=8,
                    help="continuous flow gateway: trajectory slots; decode gateway: "
                         "sequence slots")
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
                    help="gateway modes: submit via submit_stream and report the "
                         "streamed partials (flow) or tokens (decode)")
    ap.add_argument("--slo", action="store_true",
                    help="gateway modes: attach an SLOConfig (fast-reject admission, "
                         "deadline shedding, urgency order; the continuous flow "
                         "gateway also preempts at exit boundaries)")
    ap.add_argument("--slo-slack", type=float, default=0.0,
                    help="with --slo: margin in ms taken off every deadline")
    ap.add_argument("--slo-default-cost-ms", type=float, default=0.0,
                    help="with --slo: per-dispatch cost before the first "
                         "dispatch is observed")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="gateway modes: per-request deadline in ms from submit")
    ap.add_argument("--priority", type=int, default=0,
                    help="gateway modes: request priority (higher first under --slo)")
    ap.add_argument("--kernel-update", action="store_true",
                    help="accepted for the reference's CLI; the port always runs "
                         "the ns_update kernel on the card")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="gateway modes: serve /metrics (Prometheus text) and "
                         "/metrics.json on localhost at this port while traffic runs "
                         "(0 = any free port, printed)")
    ap.add_argument("--metrics-json", default=None,
                    help="gateway modes: write the final registry snapshot here")
    ap.add_argument("--stats-interval", type=float, default=0.0,
                    help="gateway modes: print a stats line every N seconds (0 = off)")
    ap.add_argument("--trace-jsonl", default=None,
                    help="gateway modes: record each request's lifecycle and write "
                         "it here as JSON lines")
    ap.add_argument("--mesh", default="none",
                    choices=["none", "host", "production", "multipod"],
                    help="flow gateway: shard the backbone over this serving mesh "
                         "(host = the 1 x 1 mesh of this process; production and "
                         "multipod need 256 and 512 ranks); 'none' = one device")
    ap.add_argument("--fleet", type=int, default=1,
                    help="flow gateway: federate N host gateways behind one submit "
                         "(FleetGateway: affinity routing, work stealing); every host "
                         "serves the same sampler")
    ap.add_argument("--ckpt", default=None,
                    help="restore the backbone's params from this checkpoint")
    ap.add_argument("--profile", default="default", choices=["default", "tuned"],
                    help="launch profile: 'tuned' re-executes once with the allocator "
                         "settings and tcmalloc preloaded where installed "
                         "(repro_torch.launch.profile)")
    return ap


def _refuse_unported(args) -> None:
    if args.arch not in ARCHS:
        raise SystemExit(f"unknown --arch {args.arch!r}; the port serves {', '.join(ARCHS)}")
    if args.mode == "flow":
        family = get_config(args.arch, smoke=args.smoke).family
        if family == "encdec" and args.gateway:
            # a gateway request carries tokens only, and the encoder needs the
            # batch's frames (the reference's gateway dies on a KeyError)
            raise SystemExit(f"--gateway: flow requests carry conditioning tokens "
                             f"only, and {args.arch}'s encoder needs audio frames; "
                             "serve it without --gateway")
    for flag, value, default in (("--mesh", args.mesh, "none"), ("--fleet", args.fleet, 1)):
        if value != default and not (args.mode == "flow" and args.gateway):
            raise SystemExit(f"{flag} serves through the flow gateway: add --gateway "
                             "(--mode flow)")
    if args.fleet < 1:
        raise SystemExit("--fleet takes at least one host")


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
    recomputes each layer in the backward: on the card one captured step
    and one captured validation (``bns.fit``). Each timing closes with a
    synchronisation, so it holds the device work."""
    anytime = spec.mode == "anytime"
    what = (f"anytime solver (budgets={spec.budgets})" if anytime
            else f"BNS solver (NFE={spec.nfe})")
    print(f"distilling {what} ...")
    field = M.velocity_field(params, cfg, sched, cond, cfg_scale=args.cfg_scale,
                             remat=True)
    shape = (args.batch, args.seq, cfg.latent_dim)
    pairs, rk45 = {}, {}
    program = RK45Program(field.fn, device)     # the two solves share its step program
    t0 = time.perf_counter()
    for i, part in enumerate(("train", "val")):
        gen = torch.Generator(device=device).manual_seed(args.seed + 1 + i)
        x0 = torch.randn(shape, generator=gen, device=device)
        res = rk45_solve(field.fn, x0, rtol=1e-5, atol=1e-5, program=program)
        pairs[part] = (x0, res.x1)
        rk45[part] = (res.nfe, res.accepted, res.rejected)
    _sync(device)
    rk45_s = time.perf_counter() - t0
    rk45_programs = program.stats()
    print(f"RK45 pairs: train nfe {rk45['train'][0]} (accepted {rk45['train'][1]}, "
          f"rejected {rk45['train'][2]}), val nfe {rk45['val'][0]} (accepted "
          f"{rk45['val'][1]}, rejected {rk45['val'][2]}), {rk45_s:.1f}s, step programs "
          f"captured {rk45_programs['programs']}, replays {rk45_programs['replays']}")
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
        rk45=rk45, rk45_seconds=rk45_s, rk45_programs=rk45_programs,
        init_val_psnr=init_psnr, init_val_seconds=init_s, val_psnr=res.val_psnr,
        iterations=args.bns_iters,
        train_seconds=train_s, iteration_seconds=res.iteration_seconds,
        num_parameters=res.num_parameters, history=res.history, params=res.params,
        solver=res.params if anytime else ns_solver.materialize(res.params),
        programs=res.programs, pairs=pairs)
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


def _init_params(args, cfg, device: torch.device) -> dict:
    """Random weights from ``--seed``, or ``--ckpt``'s params instead, restored
    into a template that holds no storage (``M.param_template``), so the
    weights are never on the device twice."""
    if args.ckpt:
        params = checkpointer.restore(args.ckpt, M.param_template(cfg), device=device)
        print(f"restored params from {args.ckpt}")
        return params
    return M.init_params(torch.Generator(device=device).manual_seed(args.seed), cfg, device)


def serve_flow(args, device: torch.device) -> FlowServed:
    cfg = get_config(args.arch, smoke=args.smoke)
    sched = get_scheduler(args.scheduler)
    params = _init_params(args, cfg, device)
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
    if args.gateway:
        result = _serve_gateway(args, sampler, cond, request_budgets)
        result.zoo, result.artifact, result.sampler = zoo.stats, artifact, sampler
        print(f"zoo stats: hits={zoo.stats.hits} misses={zoo.stats.misses} "
              f"loads={zoo.stats.loads} distills={zoo.stats.distills}")
        _print_programs(sampler, served.distillation)
        return result
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
    _print_programs(sampler, served.distillation)
    if device.type == "cuda":
        print(f"peak device memory {torch.cuda.max_memory_allocated(device) / 2**30:.3f} GiB")
    return served


def _print_programs(engine, distillation: Distillation | None = None) -> None:
    """The closing line: the programs the engine captured (CUDA graphs, one
    a key; none on the CPU, which runs eagerly) and how often they replayed,
    a distillation's training programs (its step and validation) included."""
    cache = engine.programs
    s = cache.stats()
    if distillation is not None:
        s = {k: v + distillation.programs[k] for k, v in s.items()}
    print(f"programs captured: {s['programs']}, replays {s['replays']}, capture "
          f"{s['capture_ms']:.1f} ms" + ("" if cache.active else
                                         f" (eager on {cache.device.type})"))


def _start_telemetry(args, gw, prefix: str) -> list:
    """--metrics-port / --stats-interval around a live gateway; returns the
    stop callables to run after the traffic loop."""
    stop = []
    if args.metrics_port is not None:
        srv = MetricsServer(gw.metrics_snapshot, port=args.metrics_port).start()
        print(f"metrics: http://127.0.0.1:{srv.port}/metrics (+ /metrics.json)")
        stop.append(srv.stop)
    if args.stats_interval > 0:
        printer = StatsPrinter(lambda: format_stats_line(gw.stats(), prefix=prefix),
                               args.stats_interval).start()
        stop.append(printer.stop)
    return stop


def _finish_telemetry(args, gw) -> None:
    """Write --metrics-json / --trace-jsonl after the traffic loop."""
    if args.metrics_json:
        with open(args.metrics_json, "w") as fh:
            json.dump(gw.metrics_snapshot(), fh, indent=2, sort_keys=True)
        print(f"metrics snapshot written to {args.metrics_json}")
    rec = gw.recorder
    if args.trace_jsonl and rec:
        n = rec.export_jsonl(args.trace_jsonl)
        print(f"trace: {n} events written to {args.trace_jsonl}")


def _slo(args):
    return (SLOConfig(slack_ms=args.slo_slack, default_cost_ms=args.slo_default_cost_ms)
            if args.slo else None)


def _serve_gateway(args, sampler, cond, request_budgets) -> GatewayServed:
    """Multi-user flow serving: every request is one single-sample submit
    (token row ``req % --batch``, noise seed ``1000 + req``), coalesced by
    the flush gateway or admitted into trajectories by the continuous one."""
    try:
        tiers = ShapeLadder.parse(args.tiers) if args.tiers else None
    except ValueError as e:
        raise SystemExit(f"--tiers: {e}") from None
    recorder = TraceRecorder() if args.trace_jsonl else None
    kw = dict(max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
              mixed_budget_policy=args.mixed_budget_policy, strict_nfe=args.strict_nfe,
              seed=args.seed, slo=_slo(args), tiers=tiers,
              mesh=serving_mesh(args.mesh, sampler.device))

    def make_host(rec=None):
        # the solver artifact is tiny, so every fleet host serves the SAME
        # sampler object: replication is free, distribution is the work
        if args.continuous:
            try:
                return ContinuousGateway(sampler, max_slots=args.max_slots, recorder=rec,
                                         **kw)
            except TypeError as e:
                raise SystemExit(f"--continuous: {e}") from None
        return Gateway(sampler, recorder=rec, **kw)

    if args.fleet > 1:
        # the hosts take the recorder through federate(), so every hop
        # carries its host's name
        gw = FleetGateway({f"h{i}": make_host() for i in range(args.fleet)},
                          base_seed=args.seed, recorder=recorder)
    else:
        gw = make_host(recorder)
    tokens = cond["tokens"].cpu()        # the conditioning rows, on the host once
    gw.start()
    stop_telemetry = _start_telemetry(args, gw, "gateway stats")
    t0 = time.perf_counter()
    futures = []
    try:
        for req in range(args.requests):
            req_kw = dict(tokens=tokens[req % tokens.shape[0]],
                          budget=request_budgets[req % len(request_budgets)],
                          seed=1000 + req, deadline_ms=args.deadline_ms,
                          priority=args.priority)
            try:
                futures.append(gw.submit_stream(**req_kw) if args.stream
                               else gw.submit(Request(**req_kw)))
            except AdmissionRejected as e:
                print(f"request {req}: REJECTED at admission ({e})")
                futures.append(None)
    except TierOversize as e:
        raise SystemExit(f"--tiers: {e}") from None
    except ValueError as e:
        raise SystemExit(f"--strict-nfe: {e}") from None
    finally:
        gw.shutdown()
        wall = time.perf_counter() - t0
        for fn in stop_telemetry:
            fn()
    responses, partials = [], []
    for i, fut in enumerate(futures):
        response, n = None, 0
        if fut is not None:
            try:
                if args.stream:
                    chunks = fut.chunks(timeout=60.0)
                    n = sum(1 for c in chunks if not c.final)
                    response = chunks[-1].payload
                else:
                    response = fut.result()     # a failed dispatch re-raises here
            except DeadlineExceeded:
                print(f"request {i}: SHED (deadline exceeded in queue)")
        if response is not None:
            meta = response.meta
            drift = ("" if meta["requested_budget"] == meta["served_budget"]
                     else f" (requested {meta['requested_budget']})")
            print(f"request {i}: served {meta['served_budget']} NFE{drift}, "
                  f"wait {meta['wait_ms']:.1f} ms, "
                  f"batch {meta['batch_real']}/{meta['batch_padded']}"
                  + (" [mixed]" if meta["mixed"] else "")
                  + (f", {n} streamed partials" if args.stream else ""))
        responses.append(response)
        partials.append(n)
    stats = gw.stats()
    print(format_stats_line(stats, prefix="gateway stats") + f" failed={stats['failed']}")
    if stats.get("cost_est_samples"):
        print(f"admission cost model: |estimate-actual| mean "
              f"{stats['cost_est_error_mean_ms']:.2f} ms / p95 "
              f"{stats['cost_est_error_p95_ms']:.2f} ms over "
              f"{stats['cost_est_samples']} deadline requests")
    _finish_telemetry(args, gw)
    return GatewayServed(responses=responses, partials=partials, stats=stats,
                         metrics=gw.metrics_snapshot(), wall_s=wall)


def serve_decode(args, device: torch.device):
    cfg = get_config(args.arch, smoke=args.smoke)
    params = _init_params(args, cfg, device)
    engine = DecodeEngine(params=params, cfg=cfg, window=args.window,
                          page_size=args.page_size, paged_kernel=args.paged_kernel)
    if args.gateway:
        served = _serve_decode_gateway(args, engine, cfg)
    else:
        tokens, dt = greedy_demo(engine, args.batch, args.steps, args.slots)
        print(f"decoded {args.steps} tokens x {args.batch} seqs ({dt:.1f} ms/token); "
              f"first row: {tokens[0, :8].tolist()}")
        served = GreedyDecoded(tokens=tokens, ms_per_token=dt)
    _print_programs(engine)
    return served


def _serve_decode_gateway(args, engine: DecodeEngine, cfg) -> DecodeServed:
    """Continuous decode batching: every request is one prompt -> state slot."""
    lengths = args.decode_lengths or (args.steps, max(1, args.steps // 2))
    sampling = None
    if args.temperature > 0.0 or args.top_k > 0 or args.top_p < 1.0:
        sampling = SamplingParams(temperature=args.temperature, top_k=args.top_k,
                                  top_p=args.top_p)
    gw = DecodeGateway(engine, max_slots=args.max_slots, cache_slots=args.slots,
                       prefill_chunk=args.prefill_chunk, seed=args.seed,
                       recorder=TraceRecorder() if args.trace_jsonl else None,
                       slo=_slo(args))
    t0 = time.perf_counter()
    gw.start()
    stop_telemetry = _start_telemetry(args, gw, "decode gateway stats")
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
    for fn in stop_telemetry:
        fn()
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
    _finish_telemetry(args, gw)
    return DecodeServed(responses=responses, stats=stats,
                        metrics=gw.metrics_snapshot(), wall_s=wall, engine=engine)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    args = build_parser().parse_args(argv)
    _refuse_unported(args)
    if args.profile != "default":
        maybe_reexec(args.profile, None if argv is None else [sys.argv[0]] + list(argv))
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
