"""End to end on the port: train a flow-matching model on a real
backbone from the assigned pool, then BNS-distill a sampler and serve
batched generation requests.

  PYTHONPATH=src python examples/torch/train_flow_lm.py [--arch yi-6b] [--steps 300] [--device cpu]

The twin of ``examples/train_flow_lm.py`` on ``repro_torch``: launch.train
(CFM, checkpoints) -> RK45 GT generation -> SolverSpec.distill (Algorithm 2)
-> SolverArtifact save/load -> serving.FlowSampler.from_artifact (batched
requests, exactly NFE backbone forwards per batch). Runs on the card unless
``--device cpu`` is given (exits non-zero without one); there the smoke
model's attention heads are 64 wide (``configs.for_device``: the flash
kernel's narrowest; the reference's smoke heads are 32). Noise comes from
seeded ``torch.Generator``s. ``--steps``, ``--iterations``, ``--pairs`` and
``--nfe`` size the run (defaults: the reference's 300, 300, 24 and 8).
"""
from __future__ import annotations

import argparse
import os
import tempfile

import torch

from repro_torch import resolve_device
from repro_torch.configs import for_device, get_config
from repro_torch.core.bns import BNSTrainConfig
from repro_torch.core.rk45 import rk45_solve
from repro_torch.core.schedulers import fm_ot
from repro_torch.data.synthetic import DataConfig, SyntheticTokens
from repro_torch.launch.train import train
from repro_torch.models import model as M
from repro_torch.serving.engine import FlowSampler
from repro_torch.solvers import SolverArtifact, SolverSpec


def main(argv=None) -> dict:
    """Returns the CFM losses, Euler's and the distilled solver's val PSNR,
    and the served latents' and tokens' shapes."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--nfe", type=int, default=8)
    ap.add_argument("--iterations", type=int, default=300)
    ap.add_argument("--pairs", type=int, default=24)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(str(e)) from None

    cfg = for_device(get_config(args.arch, smoke=True), dev)
    with tempfile.TemporaryDirectory() as ckpt:
        print(f"[1/4] training {args.arch} (smoke) flow model, "
              f"{args.steps} steps with checkpointing...")
        run = train(args.arch, smoke=True, steps=args.steps, batch=16, seq=16, lr=1e-3,
                    ckpt_dir=ckpt, ckpt_every=max(1, min(100, args.steps // 2)), device=dev,
                    log=lambda m: None)
        params, losses = run.params, run.losses
        print(f"      CFM loss {losses[0]:.3f} -> {losses[-1]:.3f}")

    print("[2/4] generating RK45 ground truth under the trained field...")
    data = SyntheticTokens(cfg, DataConfig(batch_size=args.pairs, seq_len=16, seed=5),
                           device=dev)
    cond = data.batch(0)
    field = M.velocity_field(params, cfg, fm_ot(), cond, cfg_scale=0.0)
    shape = (args.pairs, 16, cfg.latent_dim)
    x0 = torch.randn(shape, generator=torch.Generator(device=dev).manual_seed(2), device=dev)
    x1 = rk45_solve(field.fn, x0, rtol=1e-5, atol=1e-5).x1
    x0v = torch.randn(shape, generator=torch.Generator(device=dev).manual_seed(3), device=dev)
    x1v = rk45_solve(field.fn, x0v, rtol=1e-5, atol=1e-5).x1

    print(f"[3/4] BNS distillation at NFE={args.nfe} (Algorithm 2)...")
    spec = SolverSpec("euler", args.nfe, mode="bns")
    res = spec.distill(field, (x0, x1), (x0v, x1v),
                       BNSTrainConfig(lr=1e-3, lr_schedule="cosine",
                                      iterations=args.iterations,
                                      val_every=min(50, args.iterations),
                                      batch_size=args.pairs),
                       log=lambda m: print("      " + m))
    with torch.no_grad():
        base_psnr = SolverSpec("euler", args.nfe).sampler(field).psnr((x0v, x1v))
    print(f"      Euler {base_psnr:.2f} dB -> BNS {res.val_psnr:.2f} dB "
          f"({res.num_parameters} params, {res.wall_seconds:.0f}s)")

    print("[4/4] serving from the saved solver artifact...")
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "solver.msgpack")
        res.artifact(provenance={"arch": args.arch}).save(path)
        artifact = SolverArtifact.load(path, device=dev)
    sampler = FlowSampler.from_artifact(artifact, params=params, cfg=cfg, sched=fm_ot())
    latents = sampler.sample(cond, torch.Generator(device=dev).manual_seed(7))
    tokens = sampler.nearest_tokens(latents)
    print(f"      sampled latents {tuple(latents.shape)} -> tokens {tuple(tokens.shape)}; "
          f"{args.nfe} backbone forwards per batch.")
    return {"losses": list(losses), "euler_psnr": base_psnr, "bns_psnr": res.val_psnr,
            "latents": tuple(latents.shape), "tokens": tuple(tokens.shape)}


if __name__ == "__main__":
    main()
