"""The port's static analysis (``repro_torch.analysis``) against the
reference's ``repro.analysis``.

The copied rules (REPRO002, REPRO004, REPRO005, REPRO007) and the noqa
parsing must give the reference's findings on the same sources: the
fixture corpus and ``src/repro``, rule by rule on line, column and
message, paths compared after their anchor (``src/repro/``).  The CLI
keeps its exit codes and its byte-stable JSON, ``src/repro_torch`` is
clean against the packaged empty baseline, and each torch-analogue rule
(REPRO001 TF32 and the cuDNN guard, REPRO003 host syncs in step loops,
REPRO006 ``torch.func`` wrappers rebuilt in a loop) flags its planted
snippets and passes a clean one.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

from repro.analysis import analyze_paths as j_analyze_paths  # noqa: E402
from repro.analysis.core import parse_noqa as j_parse_noqa  # noqa: E402
from repro_torch.analysis import (analyze_paths, load_baseline,  # noqa: E402
                                  new_findings)
from repro_torch.analysis.baseline import DEFAULT_BASELINE  # noqa: E402
from repro_torch.analysis.core import parse_noqa  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "fixtures" / "analysis"
SRC_REPRO = REPO / "src" / "repro"
SRC_PORT = REPO / "src" / "repro_torch"
COPIED = ("REPRO002", "REPRO004", "REPRO005", "REPRO007")


def _keys(result, rule):
    """(path after its anchor, line, col, message) of every finding and
    suppression of ``rule``, suppressions with their justification."""
    out = []
    for f in result.findings:
        if f.rule == rule:
            out.append((f.path.split("src/repro/")[-1], f.line, f.col,
                        f.message, None))
    for s in result.suppressed:
        f = s.finding
        if f.rule == rule:
            out.append((f.path.split("src/repro/")[-1], f.line, f.col,
                        f.message, s.justification))
    return sorted(out)


def _fixture_paths():
    return sorted(p for p in FIXTURES.rglob("*.py"))


@pytest.mark.parametrize("rule", COPIED)
def test_copied_rules_give_the_references_findings_on_the_fixtures(rule):
    for path in _fixture_paths():
        got, want = analyze_paths([path]), j_analyze_paths([path])
        assert not got.errors and not want.errors
        assert _keys(got, rule) == _keys(want, rule), path


@pytest.fixture(scope="module")
def on_src_repro():
    """Each package's analysis of ``src/repro``, once."""
    return analyze_paths([SRC_REPRO]), j_analyze_paths([SRC_REPRO])


@pytest.mark.parametrize("rule", COPIED)
def test_copied_rules_give_the_references_findings_on_src_repro(
        on_src_repro, rule):
    got, want = on_src_repro
    assert got.n_files == want.n_files
    assert _keys(got, rule) == _keys(want, rule)
    if rule == "REPRO004":      # the reference's justified wall clocks
        assert len(_keys(want, rule)) >= 10


@pytest.mark.parametrize("src", [
    "x = 1  # noqa: REPRO001 -- only suppresses REPRO001\n",
    "x = 1  # noqa: REPRO004, REPRO007 -- two codes\n",
    "x = 1  # noqa: REPRO007\n",
    'MSG = "# noqa: REPRO007 -- not a comment"\n',
    "def f(:\n",
])
def test_noqa_parsing_equals_the_references(src):
    assert parse_noqa(src) == j_parse_noqa(src)


def test_noqa_fixtures_suppress_as_the_references():
    for name in ("noqa_justified.py", "noqa_unjustified.py"):
        got = analyze_paths([FIXTURES / name])
        want = j_analyze_paths([FIXTURES / name])
        assert _keys(got, "REPRO007") == _keys(want, "REPRO007")
    assert len(analyze_paths([FIXTURES / "noqa_justified.py"]).suppressed) \
        == 1


def _run_cli(*args):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               PYTHONHASHSEED="random")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)


def test_json_output_is_byte_identical_across_runs():
    runs = [_run_cli("src/repro_torch", "--format", "json")
            for _ in range(2)]
    for r in runs:
        assert r.returncode == 0, r.stdout + r.stderr
    assert runs[0].stdout == runs[1].stdout
    doc = json.loads(runs[0].stdout)
    assert doc["findings"] == [] and doc["new_findings"] == []
    assert doc["errors"] == [] and doc["suppressed"]


def test_cli_exit_codes(tmp_path):
    assert _run_cli(str(FIXTURES / "repro007_bad.py")).returncode == 1
    assert _run_cli(str(FIXTURES / "repro007_good.py")).returncode == 0
    assert _run_cli(str(tmp_path / "nope")).returncode == 2
    broken = tmp_path / "broken.py"
    broken.write_text("def (:\n", encoding="utf-8")
    assert _run_cli(str(broken)).returncode == 2
    # with no path the default is the port's package under the cwd
    proc = _run_cli()
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.splitlines()[-1].startswith("0 finding(s)")


def test_src_repro_torch_is_clean_against_the_empty_baseline():
    doc = json.loads(DEFAULT_BASELINE.read_text(encoding="utf-8"))
    assert doc["findings"] == []
    res = analyze_paths([SRC_PORT])
    assert not res.errors, res.errors
    fresh = new_findings(res, load_baseline(DEFAULT_BASELINE))
    assert not fresh, "\n".join(
        f"{f.path}:{f.line}: {f.rule} {f.message}" for f in fresh)
    assert all(f.path.startswith("src/repro_torch/")
               for f in (s.finding for s in res.suppressed))
    # the reference's justified wall clocks, carried to the port's copies
    walls = [s for s in res.suppressed if s.finding.rule == "REPRO004"]
    assert len(walls) >= 12


# ---------------------------------------------------------------------------
# the torch analogues: planted snippets each rule must flag, a clean one
# ---------------------------------------------------------------------------

TF32_BAD = [
    "import torch\ntorch.backends.cuda.matmul.allow_tf32 = True\n",
    "import torch\ntorch.backends.cudnn.allow_tf32 = flag\n",
    "import torch\ntorch.set_float32_matmul_precision('high')\n",
    "import torch\ntorch.set_float32_matmul_precision(p)\n",
    "import torch.nn.functional as F\n"
    "def f(x, w):\n    return F.conv2d(x, w)\n",
    "import torch\n"
    "def f(x, w):\n"
    "    with torch.backends.cudnn.flags(enabled=True):\n"
    "        return torch.nn.functional.conv1d(x, w)\n",
]
TF32_GOOD = """
import torch
import torch.nn.functional as F
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


def f(x, w):
    with _cudnn_guard(x):
        return F.conv2d(x, w)


def g(x, w):
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        return F.conv3d(x, w)
"""

SYNC_BAD = [
    "def f(losses):\n    for l in losses:\n        log(l.item())\n",
    "def f(xs):\n    return [x.tolist() for x in xs]\n",
    "import torch\n"
    "def f(xs):\n    for x in xs:\n        y = torch.sum(x)\n"
    "        print(float(y))\n",
    "import torch\n"
    "def f(x: torch.Tensor, n):\n"
    "    while n:\n        n -= int(x[n])\n",
    "import torch\n"
    "def f(xs):\n    acc = torch.zeros(3)\n    for x in xs:\n"
    "        if bool((acc * 2).max() > 1):\n            break\n",
    # federated/evaluation.py's: a model's output, which no name shows
    "def f(model, batches):\n    correct = 0.0\n    for bx, by, n in batches:\n"
    "        acc = (model.forward(bx).argmax(-1) == by).mean()\n"
    "        correct += float(acc) * n\n",
]
SYNC_GOOD = """
import torch


def f(xs, sizes: list[int], text: str):
    total = torch.zeros(())
    for x in xs:
        total = total + x.sum()
    n = [int(s) for s in sizes]
    m = [float(v) for v in text.split(",")]
    for i, x in enumerate(xs):
        n[i] += int(x.shape[0]) + int(len(m))
    return float(total), n


def g(x: torch.Tensor):
    return x.item()
"""

FUNC_BAD = [
    "import torch\n"
    "def f(batches, acc, p):\n    for b in batches:\n"
    "        torch.func.vmap(acc)(p, b)\n",
    "from torch.func import grad\n"
    "def f(steps, loss, p):\n    for s in steps:\n        p = p - grad(loss)(p)\n",
    "from torch.func import functional_call\n"
    "def f(model, batches):\n    for b in batches:\n"
    "        fn = lambda p: functional_call(model, p, (b,))\n"
    "        fn({})\n",
]
FUNC_GOOD = """
import torch
from torch.func import functional_call


def f(batches, acc, p):
    lanes = torch.func.vmap(acc)
    return [lanes(p, b) for b in batches]


def g(model, batches, fn_cache):
    for b in batches:
        if b not in fn_cache:
            fn_cache[b] = torch.func.vmap(
                lambda p: functional_call(model, p, (b,)))
"""


def _hits(tmp_path, source, rule, subdir="runtime"):
    d = tmp_path / subdir
    d.mkdir(parents=True, exist_ok=True)
    path = d / "snippet.py"
    path.write_text(textwrap.dedent(source), encoding="utf-8")
    res = analyze_paths([path])
    assert not res.errors, res.errors
    return [f for f in res.findings if f.rule == rule]


@pytest.mark.parametrize("rule,bad,good", [
    ("REPRO001", TF32_BAD, TF32_GOOD),
    ("REPRO003", SYNC_BAD, SYNC_GOOD),
    ("REPRO006", FUNC_BAD, FUNC_GOOD),
], ids=["REPRO001", "REPRO003", "REPRO006"])
def test_torch_rule_flags_its_planted_snippets_and_passes_a_clean_one(
        tmp_path, rule, bad, good):
    for i, src in enumerate(bad):
        assert len(_hits(tmp_path / str(i), src, rule)) == 1, src
    assert _hits(tmp_path / "good", good, rule) == []


def test_host_sync_rule_is_scoped_to_the_loop_packages(tmp_path):
    src = SYNC_BAD[0]
    for sub in ("runtime", "experiments", "federated"):
        assert len(_hits(tmp_path / sub, src, "REPRO003", sub)) == 1
    assert _hits(tmp_path / "models", src, "REPRO003", "models") == []


def test_torch_rules_are_silenced_only_by_a_justified_noqa(tmp_path):
    src = "import torch\ntorch.set_float32_matmul_precision('high')"
    assert len(_hits(tmp_path / "a", src + "  # noqa: REPRO001\n",
                     "REPRO001")) == 1
    assert _hits(tmp_path / "b", src + "  # noqa: REPRO001 -- a probe\n",
                 "REPRO001") == []
