#!/usr/bin/env python3
"""Time the ns_update backward beside diagnostic variants of it and, with
``--against DIR``, beside another checkout's backward.

    python3 scripts/ns_update_bwd_variants.py [--against DIR] [--json PATH]   # one card

Each variant is ``csrc/ns_update.cu`` with one part changed by text replacement
(each target must occur exactly once), built into ``build/repro_torch/variants``:

- no cross-block sum: the last block returns before it adds the blocks'
  partials up (da and dw are left unwritten: what the second stage costs);
- one row in flight: ``kBwdRows = 1``, a thread issues one row's loads at a
  time;
- eight rows in flight: ``kBwdRows = 8``;
- four / sixteen elements a thread: ``kBwdElems = 4`` (f32: one vector a
  thread, 256 blocks at the main shape; bf16 keeps one vector) or 16 (two
  vectors of bf16 or four of f32, 64 blocks).

``--against DIR`` adds ``DIR/src/repro_torch/kernels/csrc/ns_update.cu`` (an
earlier commit unpacked with ``git archive``) and that source with its
cross-block sum taken out the same way. Every build whose outputs are whole is
first held to the plain version at phase 3c's limits of ``chip_smoke.py``
(dU and dx0 at TOL, da and dw at TOL x the sum of |terms|) and to itself (two
calls, and a call replayed from a CUDA graph, give the same bits). Then each
build is timed at phase 3c's shapes in two rounds, the second in reverse
order: device ms a call from torch.profiler over 300 calls, and ms a call
replayed from one CUDA graph of 100 calls. Prints the card and its power
limit, ptxas' report for each build's backward kernel, and one line a build;
``--json PATH`` writes everything to PATH as well.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from chip_smoke import TOL, bound, device_ms, graphed_ms  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.ns_update import ns_update as nu_mod  # noqa: E402
from repro_torch.kernels.ns_update.ref import ns_update_bwd_ref  # noqa: E402

NO_SUM = ("  if (!last) return;\n", "  if (!last || n >= 0) return;\n")
# name -> [(text in csrc/ns_update.cu, its replacement)]
VARIANTS = {
    "no cross-block sum": [NO_SUM],
    "one row in flight": [("constexpr int kBwdRows = 4;", "constexpr int kBwdRows = 1;")],
    "eight rows in flight": [("constexpr int kBwdRows = 4;", "constexpr int kBwdRows = 8;")],
    "four elements a thread": [("constexpr int kBwdElems = 8;", "constexpr int kBwdElems = 4;")],
    "sixteen elements a thread": [("constexpr int kBwdElems = 8;",
                                   "constexpr int kBwdElems = 16;")],
}
# (k, B, D, dtype, dx0): phase 3c's shapes, the main path's first
SHAPES = [(8, 4, 65536, torch.float32, False), (1, 4, 65536, torch.float32, False),
          (8, 4, 65536, torch.bfloat16, True), (20, 3, 1000, torch.float32, True)]


def edited(text: str, edits, name: str) -> str:
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"variant {name!r}: its target occurs {text.count(old)} times")
        text = text.replace(old, new)
    return text


def sources(against: Path | None) -> dict[str, str]:
    """Each variant's source (and the other checkout's), by name."""
    src = (build.CSRC / "ns_update.cu").read_text()
    out = {name: edited(src, edits, name) for name, edits in VARIANTS.items()}
    if against is not None:
        other = (against / "src/repro_torch/kernels/csrc/ns_update.cu").read_text()
        out["against"] = other
        out["against, no cross-block sum"] = edited(other, [NO_SUM], "against")
    return out


def build_variants(against: Path | None) -> tuple[dict, dict]:
    """(name -> bound entry points, name -> ptxas lines of the backward kernel)."""
    out_dir = build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, text) in enumerate(sources(against).items()):
        cu = out_dir / f"ns_update_variant{i}.cu"
        cu.write_text(text)
        so = cu.with_suffix(".so")
        procs[name] = (so, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    log = build.library_path("ns_update").with_name(
        build.library_path("ns_update").name + ".log").read_text()
    entries = {"kernel": nu_mod.bind(build.load("ns_update"))}
    reports = {"kernel": ptxas_bwd(log)}
    for name, (so, proc) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for variant {name!r}:\n{text}")
        lib = ctypes.CDLL(str(so))
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        entries[name] = nu_mod.bind(lib)
        reports[name] = ptxas_bwd(text)
    return entries, reports


def ptxas_bwd(log: str) -> list[str]:
    """ptxas' register and spill lines for the backward kernels in ``log``."""
    lines, keep = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            keep = "ns_update_bwd_kernel" in line
            if keep:
                lines.append("bf16" if "nv_bfloat16" in line else "f32")
        elif keep and re.search(r"registers|spill", line):
            lines.append(line.split("ptxas info    :")[-1].strip())
    return lines


def inputs(k, B, D, dtype, dev):
    g = torch.Generator(device=dev).manual_seed(5)
    x0, grad = (torch.randn((B, D), generator=g, device=dev).to(dtype) for _ in "xg")
    u = torch.randn((k, B, D), generator=g, device=dev).to(dtype)
    a = torch.randn((), generator=g, device=dev)
    w = torch.randn((k,), generator=g, device=dev)
    return grad, x0, u, a, w


def check(name: str, args, need_x0: bool, whole: bool) -> None:
    """The build against the plain version (its outputs that are whole) and
    against itself: two calls and a graphed call, to the bit."""
    grad, x0, u, a, w = args
    call = lambda: nu_mod.ns_update_bwd(grad, x0, u, a, w, need_x0=need_x0)  # noqa: E731
    got, ref = call(), ns_update_bwd_ref(grad, x0, u, a, w, need_x0=need_x0)
    dtype = x0.dtype
    for x, r in zip(got[:2], ref[:2]):
        if r is not None:
            torch.testing.assert_close(x.float(), r.float(), atol=TOL[dtype], rtol=TOL[dtype],
                                       msg=lambda m: f"{name}: {m}")
    if not whole:
        return
    gf = grad.float()
    scales = torch.cat([(x0.float() * gf).abs().sum().reshape(1),
                        torch.tensordot(u.float().abs(), gf.abs(), dims=2)])
    dots = torch.cat([got[2].reshape(1), got[3]])
    want = torch.cat([ref[2].reshape(1), ref[3]])
    ratio = float(((dots - want).abs() / (TOL[torch.float32] * scales)).max())
    if not ratio <= 1:
        raise SystemExit(f"{name}: da, dw vs plain at {ratio:.3f} of the limit")
    again = call()
    if not all(torch.equal(x, y) for x, y in zip(got[1:], again[1:])):
        raise SystemExit(f"{name}: two calls differ")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        graphed = call()
    graph.replay()
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(got[1:], graphed[1:])):
        raise SystemExit(f"{name}: a graphed call differs from an eager one")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--against", type=Path, default=None,
                    help="another checkout whose csrc/ns_update.cu is timed beside this one")
    ap.add_argument("--json", type=Path, default=None, help="write the results here too")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ns_update_bwd_variants: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True, capture_output=True,
                          text=True).stdout.strip()
    print(card)
    build.build_all(("ns_update",))
    entries, reports = build_variants(args.against)
    for name, lines in reports.items():
        print(f"ptxas [{name}]: " + "; ".join(lines))
    dev = torch.device("cuda", torch.cuda.current_device())
    cases = [(k, B, D, dtype, dx0, inputs(k, B, D, dtype, dev)) for k, B, D, dtype, dx0 in SHAPES]
    for name, entry in entries.items():
        nu_mod._BOUND = entry
        for k, B, D, dtype, dx0, case in cases:
            check(f"{name} [k={k} {str(dtype)[6:]}]", case, dx0, "no cross-block sum" not in name)
            nu_mod._WORKSPACES[dev.index].counter.zero_()   # a variant may leave arrivals
    workspace = nu_mod._WORKSPACES[dev.index]
    results = {name: {} for name in entries}
    for order in (list(entries), list(entries)[::-1]):
        for name in order:
            nu_mod._BOUND = entries[name]
            for k, B, D, dtype, dx0, (grad, x0, u, a, w) in cases:
                call = lambda: nu_mod.ns_update_bwd(grad, x0, u, a, w, need_x0=dx0)  # noqa: E731,B023
                shape = f"k={k} B={B} D={D} {str(dtype)[6:]}{' dx0' if dx0 else ''}"
                row = results[name].setdefault(shape, {"device_ms": [], "graphed_ms": []})
                row["device_ms"].append(device_ms(call, "ns_update_bwd", iters=300))
                row["graphed_ms"].append(graphed_ms(call))
                N, size = x0.numel(), x0.element_size()
                row["bound_ms"] = bound((2 + 2 * k + dx0) * N * size, (3 * k + 2 + dx0) * N,
                                        dtype)[0]
                workspace.counter.zero_()      # a variant may leave arrivals
    nu_mod._BOUND = entries["kernel"]
    for name, shapes in results.items():
        print(f"[{name}] " + ", ".join(
            f"{shape}: device {r['device_ms']} graphed {r['graphed_ms']} "
            f"bound {r['bound_ms']:.4f} ms" for shape, r in shapes.items()))
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps({"card": card, "ptxas": reports, "results": results},
                                        indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
