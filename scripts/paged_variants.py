#!/usr/bin/env python3
"""Time diagnostic variants of the paged-attention kernel beside it.

    python3 scripts/paged_variants.py      # from the repository root, one card

Each variant is ``csrc/paged_attention.cu`` with one part taken out by text
replacement (each target must occur exactly once), built into
``build/repro_torch/variants``. The variants compute wrong outputs on
purpose and are not checked: they only show what a part costs.

- no math: the tiles are copied, but neither path computes scores, softmax
  or P.V (the load ring, the publish and the merge alone);
- no loads: no copies into the ring (the math alone, on whatever the ring
  holds);
- no merge: every live split writes its own output, as a lone split does
  (what publishing, the arrival count and the merge cost);
- no loads or math, and no loads, math or merge: what is left of the tile
  loop (its barriers), with and without the merge.

The kernel and its variants are timed in this one process, in two rounds
(the second in reverse order), at chip_smoke.py's phase-3 paged shapes: the
decode cell and the long rows with bf16 and f32 pages. Prints the card, then
each variant's device ms a call (torch.profiler, 300 calls).
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

from chip_smoke import device_ms, paged_inputs  # noqa: E402
from paged_compare import SHAPES  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import paged_attention as pa_mod  # noqa: E402

TILE_MMA = "      const int p0 = start + tile * kTile;\n\n      // S^T = Q K^T"
TILE_CORES = "      const int p0 = start + tile * kTile;\n\n      float part[NP];"
SKIP = "      const int p0 = start + tile * kTile;\n      if (p0 >= 0) continue;\n"
COPIES = ("    cp_async16(ks + jj * ROW + c * CE, k_pages + e, valid);\n"
          "    cp_async16(vs + jj * ROW + c * CE, v_pages + e, valid);\n")
LONE = "  if (live == 1) {                             // the only split: write the output"
# name -> [(text in csrc/paged_attention.cu, its replacement)]
VARIANTS = {
    "no math": [(TILE_MMA, TILE_MMA.replace("      const int p0 = start + tile * kTile;\n", SKIP)),
                (TILE_CORES, TILE_CORES.replace("      const int p0 = start + tile * kTile;\n",
                                                SKIP))],
    "no loads": [(COPIES, "")],
    "no merge": [(LONE, LONE.replace("live == 1", "true"))],
}
VARIANTS["no loads or math"] = VARIANTS["no loads"] + VARIANTS["no math"]
VARIANTS["no loads, math or merge"] = VARIANTS["no loads or math"] + VARIANTS["no merge"]


def sources() -> dict[str, str]:
    """The kernel's source and each variant's, by name."""
    src = (build.CSRC / "paged_attention.cu").read_text()
    out = {"kernel": src}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"variant {name!r}: its target occurs {text.count(old)} times")
            text = text.replace(old, new)
        out[name] = text
    return out


def build_variants() -> dict[str, tuple]:
    out_dir = build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, text) in enumerate(sources().items()):
        if name == "kernel":
            continue
        cu = out_dir / f"paged_attention_variant{i}.cu"
        cu.write_text(text)
        so = cu.with_suffix(".so")
        procs[name] = (so, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    entries = {"kernel": pa_mod.bind(build.load("paged_attention"))}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for variant {name!r}:\n{log}")
        lib = ctypes.CDLL(str(so))
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        entries[name] = pa_mod.bind(lib)
    return entries


def main() -> int:
    if not torch.cuda.is_available():
        print("paged_variants: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip())
    build.build_all(("paged_attention",))
    entries = build_variants()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    cases = [(name, paged_inputs(g, dev, 8, 4, 8, 128, 16, nb, torch.bfloat16, page_dtype,
                                 lengths)) for name, nb, page_dtype, lengths in SHAPES]
    for order in (list(entries), list(entries)[::-1]):
        for name in order:
            pa_mod._FN[:] = [entries[name]]       # the wrapper launches this build
            times = []
            for shape, (q, k, v, table, lens) in cases:
                ms = device_ms(lambda: pa_mod.paged_attention(q, k, v, table, lens),
                               "paged_attention", iters=300)
                times.append(f"{shape} {'not measured' if ms is None else f'{ms:.4f} ms'}")
                for state in pa_mod._DEVICES.values():   # a variant may leave arrivals
                    state.counters.zero_()
            print(f"[{name}] device time a call: " + ", ".join(times))
    pa_mod._FN[:] = [entries["kernel"]]
    return 0


if __name__ == "__main__":
    sys.exit(main())
