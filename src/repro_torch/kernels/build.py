"""Build the CUDA sources in ``csrc/`` with nvcc and bind them through ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on first
use into ``build/repro_torch/lib<name>-<hash>.so`` at the checkout's root (a
directory that ``.gitignore`` lists). The hash covers the source and the
flags, so an edited source is rebuilt and an unchanged one is loaded as is.
``build_all`` starts one nvcc per source, all at once.

Every C entry point returns ``cudaGetLastError()`` after its launch; the
Python wrappers raise when it is not 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
import weakref
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
SOURCES = ("ns_update", "flash_attention", "flash_attention_bwd", "paged_attention",
           "gla_scan", "gla_scan_bwd")

_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin, "
                       "default /usr/local/cuda/bin): the CUDA kernels cannot "
                       "be built")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str) -> tuple[Path, Path, subprocess.Popen]:
    out = library_path(name)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return out, tmp, proc


def build_all(names=SOURCES) -> dict[str, float]:
    """Compile every source not built yet, in parallel; returns seconds per build.

    The compiler's output (with ptxas's register and shared-memory report) is
    kept beside each library as ``<library>.log``.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {}
    t0 = time.perf_counter()
    for name in names:
        if not library_path(name).exists():
            started[name] = _start(name)
    seconds = {}
    failures = []
    for name, (out, tmp, proc) in started.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        out.with_name(out.name + ".log").write_text(log)
        if proc.returncode != 0:
            failures.append(f"nvcc failed for csrc/{name}.cu "
                            f"(exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failures:
        raise RuntimeError("\n".join(failures))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu`` (built now if missing)."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} at launch ({msg})")


# callables ``(name, flops, inputs, outputs)`` told of each launch that a
# launcher skipped because its inputs were fake (``analysis.counter``)
FAKE_LISTENERS: list = []
_FAKE = None


def is_fake(*xs) -> bool:
    """Whether every tensor among ``xs`` (None skipped) is a ``FakeTensor``:
    a shape-only trace (``launch.dryrun``), where a launcher allocates its
    outputs and workspaces, launches nothing and builds nothing. Never true
    for a real tensor."""
    global _FAKE
    if _FAKE is None:
        from torch._subclasses.fake_tensor import FakeTensor

        _FAKE = FakeTensor
    ts = [x for x in xs if x is not None]
    return bool(ts) and all(isinstance(x, _FAKE) for x in ts)


def fake_launch(name: str, flops: float, inputs, outputs) -> None:
    """Report a launch skipped on fake tensors, with the products it would
    run, to every listener. Not a launch: no ``LaunchCounter`` moves."""
    for listener in FAKE_LISTENERS:
        listener(name, flops, inputs, outputs)


# every live LaunchCounter: ``serving.programs`` records what a capture
# launched on each and adds it back at every replay of the graph
COUNTERS: "weakref.WeakSet[LaunchCounter]" = weakref.WeakSet()


class LaunchCounter:
    """How many times a kernel's wrapper launched it (a plain integer). A
    replayed CUDA graph adds the launches it recorded at capture
    (``serving.programs``), so the count is the same graphed or eager."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0
        COUNTERS.add(self)

    def reset(self) -> None:
        self.launches = 0
