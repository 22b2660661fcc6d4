"""Command-line entry point: ``python -m repro_torch.analysis``.

Copy of ``repro.analysis.cli``, its default path the port's package.

Exit codes: 0 — no findings beyond the baseline; 1 — new findings (the
ratchet fires); 2 — usage or internal error (unreadable baseline,
unparsable source, no files).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import List, Optional

from .baseline import (BaselineError, DEFAULT_BASELINE, load_baseline,
                       new_findings, render_baseline)
from .core import analyze_paths
from .report import to_json, to_text

EXIT_CLEAN = 0
EXIT_FINDINGS = 1
EXIT_ERROR = 2


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Parity-and-determinism static analysis for the "
                    "FedTune port (rules REPRO001–REPRO007).")
    ap.add_argument("paths", nargs="*", default=None,
                    help="files or directories to scan "
                         "(default: src/repro_torch under the current directory)")
    ap.add_argument("--format", choices=("text", "json"), default="text",
                    help="report format (default: text)")
    ap.add_argument("--baseline", type=Path, default=None,
                    help="baseline JSON of accepted findings "
                         "(default: the packaged empty baseline)")
    ap.add_argument("--write-baseline", type=Path, default=None,
                    metavar="PATH",
                    help="write a baseline accepting the current findings "
                         "to PATH and exit 0")
    ap.add_argument("--show-suppressed", action="store_true",
                    help="include justified suppressions in text output")
    ap.add_argument("--output", type=Path, default=None,
                    help="write the report to PATH as well as stdout")
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    paths = [Path(p) for p in args.paths] if args.paths else None
    if paths is None:
        default = Path("src") / "repro_torch"
        if not default.is_dir():
            print("error: no paths given and ./src/repro_torch does not "
                  "exist",
                  file=sys.stderr)
            return EXIT_ERROR
        paths = [default]
    missing = [p for p in paths if not p.exists()]
    if missing:
        print(f"error: no such path(s): "
              f"{', '.join(str(p) for p in missing)}", file=sys.stderr)
        return EXIT_ERROR

    result = analyze_paths(paths)
    if result.n_files == 0:
        print("error: no Python files found under the given paths",
              file=sys.stderr)
        return EXIT_ERROR

    if args.write_baseline is not None:
        args.write_baseline.write_text(render_baseline(result),
                                       encoding="utf-8")
        print(f"wrote baseline with {len(result.findings)} finding(s) to "
              f"{args.write_baseline}", file=sys.stderr)
        return EXIT_CLEAN

    baseline_path = args.baseline or DEFAULT_BASELINE
    try:
        baseline = load_baseline(baseline_path)
    except BaselineError as e:
        print(f"error: {e}", file=sys.stderr)
        return EXIT_ERROR

    fresh = new_findings(result, baseline)
    if args.format == "json":
        report = to_json(result, new_findings=fresh)
    else:
        report = to_text(result, new_findings=fresh,
                         show_suppressed=args.show_suppressed)
    sys.stdout.write(report)
    if args.output is not None:
        args.output.write_text(report, encoding="utf-8")

    if result.errors:
        return EXIT_ERROR
    return EXIT_FINDINGS if fresh else EXIT_CLEAN


if __name__ == "__main__":
    raise SystemExit(main())
