"""Serving launcher, flow mode: sample a flow backbone with an NS solver.

Port of the flow mode of ``repro.launch.serve``:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --mode flow \
      --full --nfe 8 --batch 4 --seq 1024 --requests 3 --bns-iters 0

Runs on the card by default (``--device cuda``, an error without one);
``--device cpu`` runs the plain CPU path. Weights are random, drawn from a
``torch.Generator`` seeded with ``--seed``; conditioning tokens come from
``SyntheticTokens``.

Without an artifact the reference distills the solver its ``_requested_spec``
names (euler at ``--nfe``, BNS mode), starting from ``build_ns("euler", nfe)``.
The port serves that initial solver when ``--bns-iters 0`` is given;
distillation, artifacts, anytime budgets and the gateway tiers exit with the
ROADMAP item that brings them — the launcher never serves something else in
their place. Each request prints its shape, its NFE and its wall time, read
after the device has finished.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.core.schedulers import get_scheduler
from repro_torch.data.synthetic import DataConfig, SyntheticTokens
from repro_torch.models import model as M
from repro_torch.serving.engine import FlowSampler
from repro_torch.solvers.registry import build_ns

DEFAULT_NFE = 8

# Options of the reference launcher that this slice does not serve yet.
_NOT_YET = {
    "bns_iters": "BNS distillation on the card (ROADMAP Queue A item 0); "
                 "pass --bns-iters 0 to serve the initial euler solver",
    "solver_artifact": "solver artifacts (ROADMAP Queue A item 3)",
    "budgets": "anytime multi-budget serving (ROADMAP Queue A item 4)",
    "gateway": "the gateway tiers (ROADMAP Queue A item 7)",
    "decode": "decode mode (ROADMAP Queue A item 9)",
}


@dataclasses.dataclass
class Served:
    """One answered request."""

    latents: torch.Tensor     # (B, S, latent_dim) f32
    tokens: torch.Tensor      # (B, S) long
    nfe: int
    ms: float                 # wall time, device work included


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
                    help="BNS distillation iterations; only 0 (serve the "
                         "initial euler solver) is served by the port yet")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--solver-artifact", default=None,
                    help="not served yet: " + _NOT_YET["solver_artifact"])
    ap.add_argument("--budgets", default=None,
                    help="not served yet: " + _NOT_YET["budgets"])
    ap.add_argument("--gateway", action="store_true",
                    help="not served yet: " + _NOT_YET["gateway"])
    return ap


def _refuse_unported(args) -> None:
    for name, on in (("decode", args.mode == "decode"),
                     ("bns_iters", args.bns_iters != 0),
                     ("solver_artifact", args.solver_artifact is not None),
                     ("budgets", args.budgets is not None),
                     ("gateway", args.gateway)):
        if on:
            raise SystemExit(f"not served by the port yet: {_NOT_YET[name]}")


def serve_flow(args, device: torch.device) -> list[Served]:
    cfg = get_config(args.arch, smoke=args.smoke)
    sched = get_scheduler(args.scheduler)
    params = M.init_params(torch.Generator(device=device).manual_seed(args.seed),
                           cfg, device)
    data = SyntheticTokens(cfg, DataConfig(batch_size=args.batch,
                                           seq_len=args.seq, seed=args.seed),
                           device=device)
    cond = data.batch(0)
    nfe = args.nfe or DEFAULT_NFE
    print(f"serving the initial euler solver at NFE {nfe} (no distillation)")
    sampler = FlowSampler(params=params, cfg=cfg, sched=sched,
                          solver=build_ns("euler", nfe), cfg_scale=args.cfg_scale)
    served = []
    for req in range(args.requests):
        _sync(device)
        t0 = time.perf_counter()
        gen = torch.Generator(device=device).manual_seed(1000 + req)
        latents = sampler.sample(cond, gen)
        tokens = sampler.nearest_tokens(latents)
        _sync(device)
        ms = (time.perf_counter() - t0) * 1e3
        print(f"request {req}: sampled {tuple(tokens.shape)} in {ms:.1f} ms "
              f"({nfe} NFE)")
        served.append(Served(latents=latents, tokens=tokens, nfe=nfe, ms=ms))
    return served


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> list[Served]:
    args = build_parser().parse_args(argv)
    _refuse_unported(args)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(str(e)) from None
    return serve_flow(args, device)


if __name__ == "__main__":
    main()
