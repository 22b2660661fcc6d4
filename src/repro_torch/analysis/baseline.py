"""Baseline ratchet: accepted findings that don't fail the build.

The checked-in baseline (``tools/analysis_baseline.json`` in CI, the
packaged ``baseline.json`` by default) lists findings that predate the
analyzer.  A run fails only on findings *not* in the baseline, so the
count can only ratchet down: fix a baselined finding and it simply
disappears; introduce a new one and CI goes red.  Identity is
``(path, rule, message)`` — line numbers shift too easily to key on.

This repo's baseline is empty by policy: every finding at introduction
time was either fixed or carries a justified ``# noqa``.

Copy of ``repro.analysis.baseline``.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import List, Set, Tuple

from .core import AnalysisResult, Finding

DEFAULT_BASELINE = Path(__file__).resolve().parent / "baseline.json"

BASELINE_VERSION = 1


class BaselineError(Exception):
    """Unreadable/invalid baseline file (exit code 2 territory)."""


def load_baseline(path: Path) -> Set[Tuple[str, str, str]]:
    try:
        doc = json.loads(path.read_text(encoding="utf-8"))
    except (OSError, json.JSONDecodeError) as e:
        raise BaselineError(f"cannot read baseline {path}: {e}") from e
    if not isinstance(doc, dict) or "findings" not in doc:
        raise BaselineError(
            f"baseline {path} must be an object with a 'findings' list")
    keys: Set[Tuple[str, str, str]] = set()
    for entry in doc["findings"]:
        try:
            keys.add((entry["path"], entry["rule"], entry["message"]))
        except (TypeError, KeyError) as e:
            raise BaselineError(
                f"baseline {path}: malformed entry {entry!r}") from e
    return keys


def new_findings(result: AnalysisResult,
                 baseline: Set[Tuple[str, str, str]]) -> List[Finding]:
    return [f for f in result.findings if f.baseline_key() not in baseline]


def render_baseline(result: AnalysisResult) -> str:
    """A baseline document accepting the current findings (for
    bootstrapping a ratchet on a tree with pre-existing findings)."""
    doc = {
        "version": BASELINE_VERSION,
        "findings": [
            {"path": f.path, "rule": f.rule, "message": f.message}
            for f in result.findings
        ],
    }
    return json.dumps(doc, sort_keys=True, indent=2) + "\n"
