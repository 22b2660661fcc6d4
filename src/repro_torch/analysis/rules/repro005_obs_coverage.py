"""REPRO005 — observability coverage and trace-schema name hygiene.

Two checks keep the observability layer honest as the engine grows:

1. **Coverage** — the engine's plan/apply/account/finish factoring is
   the replay contract the sweep runner depends on, and the layer puts a span
   on each stage so traces show the whole macro-step.  Any method named
   ``plan_*``/``apply_*``/``account_*``/``finish_*`` on a class in
   ``runtime/`` or ``experiments/`` must carry ``@obs.traced(...)`` or
   open an ``obs.span(...)`` — a new stage without a span is a blind
   spot in every Perfetto trace.
2. **Name catalog** — span names, metric names and phases are pinned in
   ``obs/trace_schema.json`` (``span_names`` / ``metric_names`` /
   ``phases``).  A literal name used at an ``obs.span``/``obs.record``/
   ``obs.traced``/``obs.counter``/``registry.inc|sample|observe|gauge``
   call site that is missing from the catalog means ``tools/
   trace_report.py`` and downstream dashboards silently drop it.

Copy of ``repro.analysis.rules.repro005_obs_coverage``.
"""

from __future__ import annotations

import ast
import json
from pathlib import Path

from ..core import FileContext, Rule, register
from ..scopes import FuncNode, dotted_parts, final_name

COVERAGE_DIRS = {"runtime", "experiments"}
STAGE_PREFIXES = ("plan_", "apply_", "account_", "finish_")
REGISTRY_METHODS = {"inc", "sample", "observe", "gauge"}
SPAN_CALLS = {"span", "record", "traced"}

_SCHEMA_PATH = Path(__file__).resolve().parents[2] / "obs" / \
    "trace_schema.json"


def _load_catalogs():
    try:
        schema = json.loads(_SCHEMA_PATH.read_text(encoding="utf-8"))
    except (OSError, json.JSONDecodeError):
        return None
    return {
        "span_names": frozenset(schema.get("span_names", ())),
        "metric_names": frozenset(schema.get("metric_names", ())),
        "phases": frozenset(schema.get("phases", ())),
    }


def _str_arg(node: ast.Call):
    if node.args and isinstance(node.args[0], ast.Constant) \
            and isinstance(node.args[0].value, str):
        return node.args[0].value
    return None


def _phase_kwarg(node: ast.Call):
    for kw in node.keywords:
        if kw.arg == "phase" and isinstance(kw.value, ast.Constant) \
                and isinstance(kw.value.value, str):
            return kw.value.value
    return None


def _has_span(method) -> bool:
    for dec in method.decorator_list:
        if isinstance(dec, ast.Call) and final_name(dec.func) == "traced" \
                and "obs" in dotted_parts(dec.func):
            return True
    for node in ast.walk(method):
        if isinstance(node, ast.Call) \
                and final_name(node.func) in {"span", "record"} \
                and "obs" in dotted_parts(node.func):
            return True
    return False


@register
class ObsCoverage(Rule):
    id = "REPRO005"
    name = "observability-coverage"

    def __init__(self):
        self._catalogs = _load_catalogs()

    def check_file(self, ctx: FileContext):
        parts = set(ctx.rel.split("/"))
        if parts & COVERAGE_DIRS:
            self._check_coverage(ctx)
        self._check_names(ctx)

    def _check_coverage(self, ctx: FileContext):
        for cls in ast.walk(ctx.tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            for method in cls.body:
                if not isinstance(method, FuncNode):
                    continue
                if not method.name.startswith(STAGE_PREFIXES):
                    continue
                if not _has_span(method):
                    ctx.add(method, self.id,
                            f"engine stage `{cls.name}.{method.name}` has "
                            "no span instrumentation — decorate with "
                            "@obs.traced(...) so traces cover every "
                            "plan/apply/account/finish stage")

    def _check_names(self, ctx: FileContext):
        if self._catalogs is None:
            return
        spans = self._catalogs["span_names"]
        metrics = self._catalogs["metric_names"]
        phases = self._catalogs["phases"]
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            chain = dotted_parts(node.func)
            last = chain[-1] if chain else None
            name = _str_arg(node)
            if name is None:
                continue
            if "obs" in chain and last in SPAN_CALLS:
                if name not in spans:
                    ctx.add(node, self.id,
                            f"span name '{name}' is not in trace_schema."
                            "json span_names — add it to the catalog so "
                            "trace tooling knows it")
                phase = _phase_kwarg(node)
                if phase is not None and phase not in phases:
                    ctx.add(node, self.id,
                            f"phase '{phase}' is not in trace_schema.json "
                            "phases — add it to the catalog")
            elif "obs" in chain and last == "counter":
                if name not in metrics:
                    ctx.add(node, self.id,
                            f"counter name '{name}' is not in trace_schema"
                            ".json metric_names — add it to the catalog")
            elif "registry" in chain and last in REGISTRY_METHODS:
                if name not in metrics:
                    ctx.add(node, self.id,
                            f"metric name '{name}' is not in trace_schema"
                            ".json metric_names — add it to the catalog "
                            "so tools/trace_report.py can label it")
