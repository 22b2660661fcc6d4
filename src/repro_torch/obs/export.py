"""Exporters: Chrome trace-event JSON, metrics JSONL, schema validation
(copy of ``repro.obs.export``; a virtual-clock span that starts a rounding
error before 0 is exported at 0, where the reference writes a negative
``ts`` that its own schema rejects).

Chrome trace layout (loadable at https://ui.perfetto.dev or
chrome://tracing):

* ``pid 1`` — **wall clock** process.  ``tid 0`` is the orchestrator
  (sweep macro-steps: PLAN/COLLECT/PACK/TRAIN/APPLY/EVAL); each trial
  lane gets its own tid in first-seen order.  ``ts``/``dur`` are host
  microseconds normalized to the earliest span.
* ``pid 2`` — **virtual clock** process.  One tid per trial lane; spans
  are simulated federated seconds (rounds, in-flight client windows,
  aggregation windows) scaled to microseconds so 1 virtual second reads
  as 1 ms on the timeline.
* A ``ph "C"`` counter track (e.g. ``t_sim``) rides on the wall process
  so simulated-time progress is visible against host time.

``validate_chrome_trace`` checks traces against the checked-in
``trace_schema.json`` (required fields per ph, numeric/nonnegative ts
and dur, monotonic ts per (pid, tid) track) without depending on the
``jsonschema`` package.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.obs.metrics import MetricsRegistry, registry
from repro_torch.obs.trace import Span, tracer

WALL_PID = 1
VIRTUAL_PID = 2
ORCHESTRATOR_TID = 0
SCHEMA_PATH = os.path.join(os.path.dirname(__file__), "trace_schema.json")

# Virtual seconds -> trace microseconds.  1e3 makes one simulated second
# read as one millisecond in Perfetto, keeping smoke sweeps (t_sim ~1e2)
# and paper-scale runs (t_sim ~1e5) both navigable.
VIRTUAL_US_PER_S = 1e3


def load_schema(path: Optional[str] = None) -> Dict[str, Any]:
    with open(path or SCHEMA_PATH, encoding="utf-8") as f:
        return json.load(f)


def _span_args(sp: Span) -> Dict[str, Any]:
    args: Dict[str, Any] = {}
    if sp.phase is not None:
        args["phase"] = sp.phase
    if sp.trial is not None:
        args["trial"] = sp.trial
    if sp.lane is not None:
        args["lane"] = sp.lane
    if sp.round_idx is not None:
        args["round"] = sp.round_idx
    for k, v in sp.attrs.items():
        args[k] = v
    return args


def chrome_trace(spans: Optional[Sequence[Span]] = None,
                 counters: Optional[Iterable[Tuple[str, float, float]]] = None,
                 ) -> Dict[str, Any]:
    """Build the trace object; defaults to the global tracer's buffers."""
    if spans is None:
        spans = tracer.spans
    if counters is None:
        counters = tracer.counters

    trial_tid: Dict[str, int] = {}

    def tid_for(trial: Optional[str]) -> int:
        if trial is None:
            return ORCHESTRATOR_TID
        if trial not in trial_tid:
            trial_tid[trial] = len(trial_tid) + 1
        return trial_tid[trial]

    wall_origins = [sp.wall_t0 for sp in spans]
    wall_origins += [t for (_n, t, _v) in counters]
    t0 = min(wall_origins) if wall_origins else 0.0

    events: List[Dict[str, Any]] = []
    for sp in spans:
        tid = tid_for(sp.trial)
        args = _span_args(sp)
        # host-only spans always get a wall event; dual-clock spans get
        # both; retroactive virtual-only spans (wall_dur == 0 with a
        # virtual extent) skip the wall track to avoid zero-width noise
        if sp.virtual_t0 is None or sp.wall_dur > 0.0:
            events.append({
                "ph": "X", "pid": WALL_PID, "tid": tid, "name": sp.name,
                "cat": sp.phase or "span",
                "ts": (sp.wall_t0 - t0) * 1e6,
                "dur": max(sp.wall_dur, 0.0) * 1e6,
                "args": args,
            })
        if sp.virtual_t0 is not None and sp.virtual_t1 is not None:
            events.append({
                "ph": "X", "pid": VIRTUAL_PID, "tid": tid, "name": sp.name,
                "cat": sp.phase or "span",
                # the virtual clock starts at 0; a window recovered by
                # subtraction (arrival - comp - trans) can round below it
                "ts": max(sp.virtual_t0, 0.0) * VIRTUAL_US_PER_S,
                "dur": max(sp.virtual_t1 - sp.virtual_t0, 0.0)
                       * VIRTUAL_US_PER_S,
                "args": args,
            })
    for name, wall_t, value in counters:
        events.append({
            "ph": "C", "pid": WALL_PID, "tid": ORCHESTRATOR_TID,
            "name": name, "ts": (wall_t - t0) * 1e6,
            "args": {"value": value},
        })

    # a single global sort by ts makes every (pid, tid) track monotonic,
    # which the checked-in schema requires
    events.sort(key=lambda e: e["ts"])

    metadata: List[Dict[str, Any]] = [
        {"ph": "M", "pid": WALL_PID, "tid": ORCHESTRATOR_TID,
         "name": "process_name", "args": {"name": "wall clock (host)"}},
        {"ph": "M", "pid": VIRTUAL_PID, "tid": ORCHESTRATOR_TID,
         "name": "process_name", "args": {"name": "virtual clock (simulated)"}},
        {"ph": "M", "pid": WALL_PID, "tid": ORCHESTRATOR_TID,
         "name": "thread_name", "args": {"name": "orchestrator"}},
        {"ph": "M", "pid": VIRTUAL_PID, "tid": ORCHESTRATOR_TID,
         "name": "thread_name", "args": {"name": "orchestrator"}},
    ]
    for trial, tid in sorted(trial_tid.items(), key=lambda kv: kv[1]):
        for pid in (WALL_PID, VIRTUAL_PID):
            metadata.append({"ph": "M", "pid": pid, "tid": tid,
                             "name": "thread_name",
                             "args": {"name": f"lane {tid - 1}: {trial}"}})

    return {"traceEvents": metadata + events, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str,
                       spans: Optional[Sequence[Span]] = None,
                       counters=None) -> Dict[str, Any]:
    trace = chrome_trace(spans, counters)
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(trace, f)
    return trace


def validate_chrome_trace(trace: Dict[str, Any],
                          schema: Optional[Dict[str, Any]] = None,
                          ) -> List[str]:
    """Return a list of violations (empty == valid)."""
    if schema is None:
        schema = load_schema()
    errors: List[str] = []
    for key in schema.get("top_level_required", []):
        if key not in trace:
            errors.append(f"missing top-level key {key!r}")
    events = trace.get("traceEvents")
    if not isinstance(events, list):
        errors.append("traceEvents is not a list")
        return errors

    allowed_ph = set(schema.get("allowed_ph", []))
    base_required = schema.get("event_required", [])
    ph_required = schema.get("ph_required", {})
    numeric = set(schema.get("numeric_fields", []))
    nonneg = set(schema.get("nonnegative_fields", []))
    last_ts: Dict[Tuple[Any, Any], float] = {}

    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            errors.append(f"event {i}: not an object")
            continue
        ph = ev.get("ph")
        if allowed_ph and ph not in allowed_ph:
            errors.append(f"event {i}: ph {ph!r} not in {sorted(allowed_ph)}")
            continue
        required = list(base_required) + list(ph_required.get(ph, []))
        missing = [k for k in required if k not in ev]
        if missing:
            errors.append(f"event {i} (ph={ph}): missing {missing}")
            continue
        bad_num = [k for k in numeric if k in ev
                   and not isinstance(ev[k], (int, float))]
        if bad_num:
            errors.append(f"event {i}: non-numeric {bad_num}")
            continue
        neg = [k for k in nonneg if k in ev and ev[k] < 0]
        if neg:
            errors.append(f"event {i}: negative {neg}")
        if ph != "M" and "ts" in ev and schema.get("monotonic_ts_per_track"):
            track = (ev.get("pid"), ev.get("tid"))
            prev = last_ts.get(track)
            if prev is not None and ev["ts"] < prev:
                errors.append(f"event {i}: ts {ev['ts']} < previous "
                              f"{prev} on track {track}")
            last_ts[track] = ev["ts"]
    return errors


def trace_paths_for(out_path: str,
                    trace_path: Optional[str] = None) -> Tuple[str, str]:
    """(trace, metrics) paths for a run whose result store is ``out_path``.

    Default: drop the store's ``.jsonl`` suffix and add ``.trace.json`` /
    ``.metrics.jsonl`` — keeping the trace next to the sweep store.  An
    explicit ``trace_path`` overrides the trace location; its companion
    metrics file sits next to IT (swapping a ``.json`` suffix)."""
    if trace_path is not None:
        base = trace_path[:-5] if trace_path.endswith(".json") else trace_path
        if base.endswith(".trace"):
            base = base[: -len(".trace")]
        return trace_path, base + ".metrics.jsonl"
    base = out_path[:-6] if out_path.endswith(".jsonl") else out_path
    return base + ".trace.json", base + ".metrics.jsonl"


# ---- metrics JSONL ----------------------------------------------------


def metrics_rows(reg: Optional[MetricsRegistry] = None) -> List[Dict[str, Any]]:
    """Flatten a registry into self-describing JSONL rows."""
    if reg is None:
        reg = registry
    rows: List[Dict[str, Any]] = []
    for row in reg.series():
        rows.append({"kind": "sample", **row})
    for name, value in sorted(reg.counters().items()):
        rows.append({"kind": "counter", "name": name, "value": value})
    for name, value in sorted(reg.gauges().items()):
        rows.append({"kind": "gauge", "name": name, "value": value})
    for name, summary in reg.histograms().items():
        rows.append({"kind": "histogram", "name": name, **summary})
    for name, secs in sorted(reg.phase_snapshot().items()):
        rows.append({"kind": "phase", "name": name, "seconds": secs,
                     "calls": reg.phase_call_count(name)})
    return rows


def write_metrics_jsonl(path: str,
                        reg: Optional[MetricsRegistry] = None) -> int:
    rows = metrics_rows(reg)
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")
    return len(rows)


def read_metrics_jsonl(path: str) -> List[Dict[str, Any]]:
    rows = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    return rows
