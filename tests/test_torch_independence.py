"""The port stands alone: ``repro_torch`` (and ``chip_smoke.py``) import
neither JAX nor any module of the JAX package."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(r"^\s*(import\s+(jax|jaxlib|repro)(\.|\s|,|$)"
                       r"|from\s+(jax|jaxlib|repro)(\.|\s))", re.M)

_PROBE = r"""
import importlib, pkgutil, sys
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len(names), bad)
"""


def test_importing_every_port_module_loads_no_jax_and_no_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _PROBE], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    count, bad = proc.stdout.strip().split(" ", 1)
    assert int(count) >= 20
    assert bad == "[]", f"the port pulled in {bad}"


@pytest.mark.parametrize("path", sorted(
    [p.relative_to(ROOT) for p in PORT.rglob("*.py")] + [Path("chip_smoke.py")]),
    ids=str)
def test_source_has_no_jax_or_repro_import(path):
    text = (ROOT / path).read_text()
    hits = [m.group(0).strip() for m in FORBIDDEN.finditer(text)]
    assert not hits, f"{path}: {hits}"


def test_scan_catches_what_it_should():
    for line in ("import jax", "import jax.numpy as jnp", "from jax import lax",
                 "from repro.core import toy", "import repro.models",
                 "    from repro.kernels.ns_update.ops import x"):
        assert FORBIDDEN.search(line), line
    for line in ("import repro_torch", "from repro_torch.core import toy",
                 "import numpy as np", "# see repro.core.toy"):
        assert not FORBIDDEN.search(line), line
