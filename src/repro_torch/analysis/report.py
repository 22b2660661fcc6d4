"""Finding reporters: human text and byte-stable JSON.

The JSON form is the ratchet's currency — it must be byte-identical for
identical inputs (sorted findings, ``sort_keys``, fixed indent, no
timestamps/absolute paths), because the determinism test diffs two runs
and CI diffs against the checked-in baseline.

Copy of ``repro.analysis.report``.
"""

from __future__ import annotations

import json
from typing import List

from .core import AnalysisResult, Finding, Suppression

JSON_VERSION = 1


def to_json(result: AnalysisResult, *, new_findings: List[Finding]) -> str:
    doc = {
        "version": JSON_VERSION,
        "n_files": result.n_files,
        "findings": [f.to_dict() for f in result.findings],
        "new_findings": [f.to_dict() for f in new_findings],
        "suppressed": [
            {**s.finding.to_dict(), "justification": s.justification}
            for s in result.suppressed
        ],
        "errors": list(result.errors),
    }
    return json.dumps(doc, sort_keys=True, indent=2) + "\n"


def to_text(result: AnalysisResult, *, new_findings: List[Finding],
            show_suppressed: bool = False) -> str:
    lines: List[str] = []
    new_keys = {f.sort_key() for f in new_findings}
    for f in result.findings:
        marker = "" if f.sort_key() in new_keys else " [baseline]"
        lines.append(
            f"{f.path}:{f.line}:{f.col + 1}: {f.rule} {f.message}{marker}")
    if show_suppressed:
        for s in result.suppressed:
            f = s.finding
            lines.append(
                f"{f.path}:{f.line}:{f.col + 1}: {f.rule} suppressed — "
                f"{s.justification}")
    for err in result.errors:
        lines.append(f"error: {err}")
    lines.append(
        f"{len(result.findings)} finding(s) "
        f"({len(new_findings)} new, {len(result.suppressed)} suppressed) "
        f"in {result.n_files} file(s)")
    return "\n".join(lines) + "\n"
