"""The port stands alone: ``repro_torch``, ``chip_smoke.py`` and the
examples' twins (``examples/torch``) import neither JAX nor any module of the
JAX package."""
import ast
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


TWINS = sorted(p.relative_to(ROOT) for p in (ROOT / "examples" / "torch").glob("*.py"))


@pytest.mark.parametrize("path", sorted(
    [p.relative_to(ROOT) for p in PORT.rglob("*.py")] + [Path("chip_smoke.py")] + TWINS),
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


def test_the_examples_twins_import_only_the_port_torch_numpy_and_the_stdlib():
    allowed = {"repro_torch", "torch", "numpy", "__future__"} | set(sys.stdlib_module_names)
    assert [p.name for p in TWINS] == ["gateway_demo.py", "quickstart.py", "serve_decode.py",
                                       "solver_zoo.py", "train_flow_lm.py"]
    for path in TWINS:
        tree = ast.parse((ROOT / path).read_text())
        roots = {alias.name.split(".")[0] for node in ast.walk(tree)
                 if isinstance(node, ast.Import) for alias in node.names}
        roots |= {node.module.split(".")[0] for node in ast.walk(tree)
                  if isinstance(node, ast.ImportFrom) and node.module}
        assert roots <= allowed, f"{path}: {sorted(roots - allowed)}"


@pytest.mark.parametrize("module", ["repro_torch.launch.dryrun", "repro_torch.analysis",
                                    "repro_torch.analysis.counter"])
def test_the_dry_run_and_its_counter_load_no_jax_and_no_repro(module):
    """The dry run and the cost counter, the twins of ``repro.launch.dryrun``
    and ``repro.analysis.hlo``, stand alone: imported by themselves (and the
    dry run's argument parser run) they pull in neither JAX nor the
    reference."""
    probe = (f"import sys, {module} as m\n"
             "if hasattr(m, 'main'):\n"
             "    try:\n        m.main(['--help'])\n    except SystemExit:\n        pass\n"
             "print(sorted(k for k in sys.modules if k.split('.')[0] in "
             "('jax', 'jaxlib', 'repro')))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", probe], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def test_the_source_scan_covers_the_dry_run_and_the_counter():
    scanned = {p.relative_to(ROOT) for p in PORT.rglob("*.py")}
    assert Path("src/repro_torch/launch/dryrun.py") in scanned
    assert {Path("src/repro_torch/analysis/__init__.py"),
            Path("src/repro_torch/analysis/counter.py")} <= scanned
