"""Time one row of ``repro_torch.benchmarks.psnr_vs_nfe`` on the card with
the mixture field's tensors held on the host and on the card, in one process
(host, card, card, host) on shared RK45 pairs, so that the two differ only
in where the field's means, stds and weights lie (on the host each field
evaluation copies them to the card and waits for the copy).

    PYTHONPATH=src python3 scripts/psnr_row_ab.py [scheduler] [nfe] [iterations]

Defaults: vp, NFE 16 (the benchmark's slowest row), 200 iterations for each
of BNS and BST. Prints each run's wall time, its BNS and BST training
seconds and its PSNRs, which must agree between the four runs.
"""
from __future__ import annotations

import subprocess
import sys
import time

import torch

from repro_torch.benchmarks import psnr_vs_nfe as bench
from repro_torch.core.bns import generate_pairs


def main(sname: str = "vp", nfe: int = 16, iterations: int = 200) -> int:
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    field = bench.make_field(sname, dev)
    pairs = {sname: tuple(generate_pairs(field, torch.Generator(device=dev).manual_seed(s),
                                         256, (2,)) for s in (0, 1))}
    bench.SCHEDS, bench.NFES = [sname], [nfe]
    make = bench.make_field
    psnrs = set()
    for where in ("host", "card", "card", "host"):
        bench.make_field = (lambda s, d, w=where: make(s, "cpu" if w == "host" else d))
        t0 = time.perf_counter()
        row, = bench.run(iterations, pairs=pairs, device=dev, log=lambda s: None)
        wall = time.perf_counter() - t0
        psnrs.add(tuple(v for k, v in row.items() if isinstance(v, float)
                        and not k.endswith("_train_s")))
        print(f"field on the {where}: {sname} NFE {nfe}, {iterations} iterations: wall "
              f"{wall:.3f} s, bns {row['bns_train_s']} s, bst {row['bst_train_s']} s, "
              f"PSNR {row}")
    bench.make_field = make
    if len(psnrs) != 1:
        print(f"the four runs disagree: {psnrs}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(*(f(a) for f, a in zip((str, int, int), sys.argv[1:]))))
