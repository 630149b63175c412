"""Tuned launch profile: allocator settings + allocator preload for serving.

Port of ``repro.launch.profile``. ``serve.py --profile tuned`` re-executes
the process once with a serving-oriented environment before anything
touches the card:

* ``TUNED_ALLOC_CONF`` — PyTorch's CUDA caching-allocator options
  (``PYTORCH_CUDA_ALLOC_CONF``, read when the allocator starts), the port's
  counterpart of the reference's XLA flag set: expandable segments, so the
  allocator grows a mapping instead of caching blocks of fixed sizes.
* tcmalloc — host-side allocator preload (``LD_PRELOAD``), applied only
  when one of the reference's known shared-object paths exists on this
  machine, with the reference's large-alloc report threshold.

Everything except the ``os.execve`` is pure and unit-testable:
``merge_alloc_conf`` / ``apply_profile`` build the target environment
mapping without touching the process. ``maybe_reexec`` performs the
re-exec, guarded by the ``REPRO_TUNED_REEXEC`` sentinel so the re-launched
process runs straight through.
"""
from __future__ import annotations

import os
import sys

TUNED_ALLOC_CONF = ("expandable_segments:True",)

TCMALLOC_CANDIDATES = (
    "/usr/lib/x86_64-linux-gnu/libtcmalloc.so.4",
    "/usr/lib/x86_64-linux-gnu/libtcmalloc_minimal.so.4",
)

_SENTINEL = "REPRO_TUNED_REEXEC"


def merge_alloc_conf(existing: str, extra) -> str:
    """Merge ``extra`` options into a ``PYTORCH_CUDA_ALLOC_CONF`` string
    (comma-separated ``key:value``), deduplicating by KEY: an option the
    user already set wins over the profile's default for it."""
    merged = []
    seen = set()
    for opt in [o.strip() for o in existing.split(",") if o.strip()] + list(extra):
        key = opt.split(":", 1)[0].strip()
        if key in seen:
            continue
        seen.add(key)
        merged.append(opt)
    return ",".join(merged)


def apply_profile(name: str, env=None) -> dict:
    """Return a COPY of ``env`` (default ``os.environ``) with the named
    profile applied. ``default`` returns the environment untouched;
    ``tuned`` merges ``TUNED_ALLOC_CONF`` into ``PYTORCH_CUDA_ALLOC_CONF``
    and preloads tcmalloc when one of the candidate paths exists."""
    base = dict(os.environ if env is None else env)
    if name == "default":
        return base
    if name != "tuned":
        raise ValueError(f"unknown launch profile {name!r}")
    base["PYTORCH_CUDA_ALLOC_CONF"] = merge_alloc_conf(
        base.get("PYTORCH_CUDA_ALLOC_CONF", ""), TUNED_ALLOC_CONF)
    lib = next((p for p in TCMALLOC_CANDIDATES if os.path.exists(p)), None)
    if lib is not None:
        preload = base.get("LD_PRELOAD", "")
        if lib not in preload.split(":"):
            base["LD_PRELOAD"] = f"{preload}:{lib}".strip(":")
        base.setdefault("TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD", "60000000000")
    return base


def maybe_reexec(profile: str, argv=None, log=print) -> None:
    """Re-exec the current interpreter once under the tuned environment.

    No-op for the default profile, and for the re-launched child (the
    ``REPRO_TUNED_REEXEC`` sentinel breaks the loop). ``LD_PRELOAD`` must be
    set before the dynamic loader reads it, which for a running process
    means replacing it; ``argv`` (default ``sys.argv``) is the launcher's
    command line, program name first."""
    if profile == "default" or os.environ.get(_SENTINEL):
        return
    env = apply_profile(profile)
    env[_SENTINEL] = "1"
    argv = list(sys.argv if argv is None else argv)
    log(f"re-exec under '{profile}' profile: "
        f"PYTORCH_CUDA_ALLOC_CONF={env['PYTORCH_CUDA_ALLOC_CONF']!r}"
        + (f", LD_PRELOAD={env['LD_PRELOAD']}" if "LD_PRELOAD" in env
           else " (tcmalloc not found, skipped)"))
    sys.stdout.flush()
    os.execve(sys.executable, [sys.executable, "-m", "repro_torch.launch.serve"]
              + argv[1:], env)
