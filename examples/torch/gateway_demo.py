"""Gateway demo on the port: many users, one anytime solver, coalesced batches.

  PYTHONPATH=src python examples/torch/gateway_demo.py [--device cpu]

The twin of ``examples/gateway_demo.py`` on ``repro_torch``. Boots the smoke
backbone with an (untrained — mechanics, not quality) anytime solver serving
budgets {2, 4}, starts the gateway's serving thread, and fires 12 concurrent
single-sample requests with mixed NFE budgets — including an unserved budget
3, whose drift to a served budget comes back in the response metadata. The
batcher coalesces them into padded fixed-bucket batches; a flush spanning
both budgets rides the shared anytime trajectory (one dispatch at
max(budgets) forwards) when that is cheaper. Runs on the card unless
``--device cpu`` is given (exits non-zero without one); there the smoke
model's attention heads are 64 wide (``configs.for_device``: the flash
kernel's narrowest; the reference's smoke heads are 32). Each request's
noise comes from its seed.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import resolve_device
from repro_torch.configs import for_device, get_config
from repro_torch.core.anytime import init_anytime
from repro_torch.core.schedulers import fm_ot
from repro_torch.data.synthetic import DataConfig, SyntheticTokens
from repro_torch.models import model as M
from repro_torch.serving import AnytimeFlowSampler, Gateway, Request
from repro_torch.solvers import SolverArtifact, SolverSpec

BUDGETS = (2, 4)
REQUESTS = 12


def main(argv=None) -> dict:
    """Returns each response's metadata (``metas``) and the gateway's stats."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(str(e)) from None
    cfg = for_device(get_config("yi-6b", smoke=True), dev)
    params = M.init_params(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    data = SyntheticTokens(cfg, DataConfig(batch_size=4, seq_len=8), device=dev)
    tokens = data.batch(0)["tokens"]
    artifact = SolverArtifact(
        spec=SolverSpec("midpoint", mode="anytime", budgets=BUDGETS),
        params=init_anytime(None, BUDGETS), val_psnr=0.0)
    sampler = AnytimeFlowSampler.from_artifact(artifact, params=params, cfg=cfg, sched=fm_ot())

    gateway = Gateway(sampler, max_batch=4, max_wait_ms=20.0, mixed_budget_policy="auto")
    gateway.start()
    print(f"submitting {REQUESTS} requests at budgets cycling (2, 4, 3):")
    futures = [gateway.submit(Request(tokens=tokens[i % tokens.shape[0]],
                                      budget=(2, 4, 3)[i % 3], seed=100 + i))
               for i in range(REQUESTS)]
    gateway.shutdown()           # graceful drain, then stop the thread

    metas = []
    for i, fut in enumerate(futures):
        meta = fut.result().meta
        metas.append(meta)
        drift = ("" if meta["requested_budget"] == meta["served_budget"]
                 else f"  (drift: requested {meta['requested_budget']})")
        print(f"  request {i}: {meta['served_budget']} NFE, "
              f"batch {meta['batch_real']}/{meta['batch_padded']}"
              + (" [mixed]" if meta["mixed"] else "") + drift)
    s = gateway.stats()
    print(f"{s['completed']} samples in {s['batches']} batches "
          f"({s['mixed_batches']} mixed): {s['forwards']} backbone forwards "
          f"total, {s['nfe_per_request']:.2f} NFE/request, "
          f"occupancy {s['occupancy']:.2f}, "
          f"mean wait {s['mean_wait_ms']:.1f} ms")
    return {"metas": metas, "stats": s}


if __name__ == "__main__":
    main()
