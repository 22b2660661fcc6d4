"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither ``jax`` nor any ``repro`` module, nor ``ml_dtypes`` (the
checkpointer carries bfloat16 as raw bits).

Checked twice: dynamically, by importing every ``repro_torch`` module in a
fresh interpreter and inspecting ``sys.modules``; and statically, by
scanning every import statement of the port's files.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"

_PROBE = r"""
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
# the sharding package (DTensor meshes) imports torch.distributed.tensor
# lazily; import it here so its imports are checked too
import torch.distributed.tensor  # noqa: F401
assert {"repro_torch.sharding", "repro_torch.sharding.ctx",
        "repro_torch.sharding.specs"} <= set(names), names
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro.")
             or m == "ml_dtypes" or m.startswith("ml_dtypes."))
print(len(names), bad)
sys.exit(1 if bad else 0)
"""


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro", "ml_dtypes")


def test_importing_every_port_module_loads_no_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_modules = int(proc.stdout.split()[0])
    assert n_modules >= 30


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_port_file_imports_jax_or_repro():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 30
    offenders = [(str(f.relative_to(REPO)), m) for f in files
                 for m in _imports(f) if _forbidden(m)]
    assert offenders == []


def test_the_scan_catches_a_forbidden_import(tmp_path):
    f = tmp_path / "x.py"
    f.write_text("import numpy\nfrom repro.kernels import ref\n"
                 "import jax.numpy as jnp\nfrom repro_torch import tree\n"
                 "import ml_dtypes\n")
    assert [m for m in _imports(f) if _forbidden(m)] == ["repro.kernels",
                                                         "jax.numpy",
                                                         "ml_dtypes"]
