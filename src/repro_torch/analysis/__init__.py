"""repro_torch.analysis — parity-and-determinism static analysis of the port.

Copy of ``repro.analysis`` (the port imports nothing of ``repro``): an AST
pass over the port's sources, seven repo-specific rules (REPRO001–REPRO007),
justified ``# noqa`` suppressions, deterministic text/JSON reports and a
baseline ratchet.  REPRO002, REPRO004, REPRO005 and REPRO007 are the
reference's rules as they are; REPRO001, REPRO003 and REPRO006 keep their
ids but guard the hazards PyTorch has where the reference's guard XLA's:
TF32 switched on and convolutions outside the cuDNN guard (001), host
syncs in per-step loops (003), and ``torch.func`` wrappers rebuilt in a
loop (006).

Entry point: ``python -m repro_torch.analysis [paths]`` (default
``src/repro_torch``).

Deliberately dependency-free (stdlib ``ast`` only — no torch import), so
it runs anywhere Python does.
"""

from .baseline import DEFAULT_BASELINE, load_baseline, new_findings
from .core import (AnalysisResult, FileContext, Finding, Rule, Suppression,
                   all_rules, analyze_paths, register)
from .report import to_json, to_text

__all__ = [
    "AnalysisResult", "DEFAULT_BASELINE", "FileContext", "Finding", "Rule",
    "Suppression", "all_rules", "analyze_paths", "load_baseline",
    "new_findings", "register", "to_json", "to_text",
]
