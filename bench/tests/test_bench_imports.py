"""What the harness runs loads neither JAX nor the JAX package (top-level
names compared whole: the program ``repro_torch`` begins with ``repro``),
and the reference imports nothing of the program."""

import ast
import json
import subprocess
import sys

from conftest import BENCH


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


def test_reference_imports_nothing_of_the_program():
    for p in (BENCH / "reference").rglob("*.py"):
        mods = set(_imports(p))
        assert not mods & {"repro_torch", "repro", "jax", "jaxlib", "flax"}
        assert mods <= {"__future__", "contextlib", "math", "typing",
                        "torch"}, (p, mods)


def test_no_module_of_a_run_is_jax_or_the_jax_package():
    """A whole small run of every cell in a fresh process, then its
    ``sys.modules`` by top-level name."""
    code = f"""
import json, sys, time
sys.path[:0] = [{str(BENCH / 'tests')!r}]
import conftest
from benchlib import harness
for cell in conftest.cells():
    model, traffic = conftest.small(cell)
    harness.run_cell(cell, 3, 0.05, cell.endswith("2k"), "cpu",
                     time.perf_counter(), model=model, traffic=traffic)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
print(json.dumps(harness.forbidden_modules()))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=BENCH.parent)
    assert out.returncode == 0, out.stderr[-3000:]
    tops, bad = (json.loads(x) for x in out.stdout.splitlines()[-2:])
    assert "repro_torch" in tops and "torch" in tops
    assert bad == []
    assert not {"jax", "jaxlib", "flax", "repro"} & set(tops)


def test_forbidden_names_are_whole_words():
    from benchlib import harness
    sys.modules.setdefault("repro_torch_probe_only", sys)
    try:
        assert "repro_torch_probe_only" not in harness.forbidden_modules()
    finally:
        del sys.modules["repro_torch_probe_only"]
