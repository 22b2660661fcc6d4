"""Append-only JSONL result store with resume-by-trial-key, seed
aggregation, and the paper-style table emitter.

One line per finished trial (the dict from ``TrialResult.to_record``).
Appends are line-atomic enough for the resume contract: a sweep killed
mid-write leaves at most one truncated final line, which ``load`` skips —
so re-invoking the sweep reruns exactly the unfinished trials.

The table emitter reproduces the paper's reporting convention: every
FedTune trial is normalized against its FixedTuner twin (same dataset,
aggregator, seed, M0/E0 — ``baseline_key``) through eq. (6) under the
trial's own preference vector, and the '+x%' numbers are mean +- std over
seeds.  Positive = FedTune reduced the weighted system overhead.  Stores
spanning several fleet profiles, runtime modes, or compression methods
render those as extra column suffixes (``fedavg·stragglers``,
``fedavg·int8``); records from before those axes existed tabulate under
the defaults (homogeneous/sync/uncompressed) instead of KeyError-ing, so
old stores keep resuming and tabulating.

Copy of ``repro.experiments.store`` without its tracing hooks; the port
imports nothing of ``repro``.  The record schema is the reference's, so a
store written by either package resumes and tabulates in the other.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterable, List, Optional

import numpy as np

from repro_torch.core.costs import SystemCost
from repro_torch.core.preferences import Preference
from repro_torch.experiments.grid import TrialSpec, spec_from_dict


class ResultStore:
    def __init__(self, path: str):
        self.path = path
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        # completed-key cache: None until first asked, then maintained by
        # append/clear so admission checks are O(1) instead of a full
        # JSONL re-parse per call (the scheduler asks once per admission)
        self._completed: Optional[set] = None

    # ------------------------------------------------------------------
    def load(self) -> List[dict]:
        """Every valid record; corrupt/truncated lines (a killed writer's
        tail) are skipped, not fatal."""
        if not os.path.exists(self.path):
            return []
        out = []
        with open(self.path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except json.JSONDecodeError:
                    continue
        return out

    def completed_keys(self) -> set:
        """Keys of every ``status == "done"`` record.  The file is parsed
        at most once: the set is cached and kept current by ``append``
        (add) and ``clear`` (invalidate).  Treat the returned set as
        read-only — it IS the cache."""
        if self._completed is None:
            self._completed = {r["key"] for r in self.load()
                               if r.get("status") == "done" and "key" in r}
        return self._completed

    def is_completed(self, key: str) -> bool:
        """O(1) membership against the cached completed-key set — the
        scheduler's per-admission resume check."""
        return key in self.completed_keys()

    def append(self, record: dict):
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")
            f.flush()
            os.fsync(f.fileno())
        if (self._completed is not None
                and record.get("status") == "done" and "key" in record):
            self._completed.add(record["key"])

    def clear(self):
        if os.path.exists(self.path):
            os.remove(self.path)
        self._completed = None


# ---------------------------------------------------------------------------
# aggregation + table emission
# ---------------------------------------------------------------------------

def _spec_of(record: dict) -> TrialSpec:
    """The record's TrialSpec, tolerant of legacy rows: fields a record
    predates (e.g. ``het`` before fleet-profile axes existed) fall back to
    the TrialSpec defaults instead of KeyError-ing — resuming or tabulating
    an old store must never crash on schema growth."""
    return spec_from_dict(record.get("spec") or {})


def improvement_pct(record: dict, baseline: dict) -> float:
    """The paper's '+x%' convention: -100 * I(fixed, tuned) under the tuned
    trial's preference (positive = FedTune reduced the weighted overhead)."""
    pref = Preference(*_spec_of(record).preference)
    tuned = SystemCost(*record["cost"])
    fixed = SystemCost(*baseline["cost"])
    return -100.0 * tuned.weighted_relative_to(fixed, pref)


def _cell_id(spec: TrialSpec) -> tuple:
    """Table cell identity: every result-bearing axis except seed (the
    aggregation dimension) and tuner (the comparison dimension).  A store
    holding e.g. both a stragglers and a homogeneous sweep must NOT mix
    them into one cell as if they were extra seeds."""
    return (spec.dataset, spec.aggregator, spec.preference, spec.m0,
            spec.e0, spec.mode, spec.rounds, spec.reduced, spec.het,
            spec.batch_size, spec.target_accuracy, spec.lr,
            spec.eval_points, spec.prox_mu, spec.compression)


def pair_with_baselines(records: Iterable[dict]) -> List[dict]:
    """Attach each fedtune record's FixedTuner twin (matched by
    ``baseline_key``) and its improvement; records without a baseline are
    dropped (a partial sweep's fedtune rows can't be normalized yet)."""
    records = list(records)
    by_key: Dict[str, dict] = {r["key"]: r for r in records
                               if r.get("status") == "done" and "key" in r}
    out = []
    for r in records:
        if r.get("status") != "done" or _spec_of(r).tuner != "fedtune":
            continue
        base = by_key.get(r.get("baseline_key"))
        if base is None:
            continue
        out.append({**r, "improvement": improvement_pct(r, base)})
    return out


def aggregate_over_seeds(paired: Iterable[dict]) -> List[dict]:
    """Group paired fedtune records by table cell (all axes except seed)
    and report mean +- std of improvement / accuracy / rounds."""
    cells: Dict[tuple, List[dict]] = {}
    for r in paired:
        spec = _spec_of(r)
        cells.setdefault(_cell_id(spec), []).append(r)
    out = []
    for cell, rs in sorted(cells.items(), key=lambda kv: repr(kv[0])):
        imps = np.array([r["improvement"] for r in rs], np.float64)
        accs = np.array([r["final_accuracy"] for r in rs], np.float64)
        rounds = np.array([r["rounds"] for r in rs], np.float64)
        out.append({
            "dataset": cell[0], "aggregator": cell[1],
            "preference": list(cell[2]), "m0": cell[3], "e0": cell[4],
            "mode": cell[5], "het": cell[8], "compression": cell[14],
            "n_seeds": len(rs),
            "improvement_mean": float(imps.mean()),
            "improvement_std": float(imps.std()),
            "accuracy_mean": float(accs.mean()),
            "rounds_mean": float(rounds.mean()),
        })
    return out


def _fmt_pref(p) -> str:
    return "(" + ",".join(f"{v:g}" for v in p) + ")"


def _column_of(row: dict, multi_het: bool, multi_mode: bool,
               multi_comp: bool = False) -> str:
    """Column identity for one aggregated cell: the aggregator, widened by
    runtime-mode, fleet-profile, and compression suffixes when the store
    spans those axes (e.g. ``fedavg·async``, ``fedavg·stragglers``,
    ``fedavg·int8``) so a mode/het/compression sweep renders as
    side-by-side columns instead of collapsing into one.  Legacy rows
    written before an axis existed default to that axis's default value
    (homogeneous / sync / no compression)."""
    col = row["aggregator"]
    if multi_mode and row.get("mode"):
        col += f"·{row['mode']}"
    if multi_het:
        col += f"·{row.get('het') or 'homogeneous'}"
    if multi_comp:
        col += f"·{row.get('compression') or 'none'}"
    return col


def paper_table(records: Iterable[dict], *,
                title: Optional[str] = None) -> str:
    """Markdown tables in the paper's layout: one section per dataset, rows
    = preference vectors, columns = aggregators, cells = mean +- std
    overhead reduction of FedTune vs the FixedTuner baseline.  When the
    store spans several fleet profiles (``SweepSpec.hets``) or runtime
    modes, the aggregator columns split per profile/mode
    (``fedavg·stragglers``, ``fedavg·async``, ...); legacy records written
    before those axes existed default to homogeneous/sync rather than
    erroring."""
    agg = aggregate_over_seeds(pair_with_baselines(records))
    if not agg:
        return "(no fedtune/baseline pairs to tabulate yet)"
    lines = []
    if title:
        lines.append(f"## {title}")
    datasets = sorted({a["dataset"] for a in agg})
    for ds in datasets:
        rows = [a for a in agg if a["dataset"] == ds]
        multi_het = len({a.get("het") or "homogeneous" for a in rows}) > 1
        multi_mode = len({a.get("mode") or "sync" for a in rows}) > 1
        multi_comp = len({a.get("compression") or "none"
                          for a in rows}) > 1
        cols = sorted({_column_of(a, multi_het, multi_mode, multi_comp)
                       for a in rows})
        prefs = []
        for a in rows:
            key = tuple(a["preference"])
            if key not in prefs:
                prefs.append(key)
        lines.append(f"\n### {ds} — FedTune overhead reduction vs "
                     "FixedTuner (+ = better)")
        lines.append("| preference (a,b,g,d) | " + " | ".join(cols) + " |")
        lines.append("|---" * (len(cols) + 1) + "|")
        for p in prefs:
            cells = []
            for col in cols:
                m = [a for a in rows
                     if tuple(a["preference"]) == p
                     and _column_of(a, multi_het, multi_mode,
                                    multi_comp) == col]
                if not m:
                    cells.append("—")
                    continue
                parts = []
                for a in m:   # one entry per remaining (M0, E0) grid point
                    v = (f"{a['improvement_mean']:+.2f}"
                         f"±{a['improvement_std']:.2f}%")
                    if len(m) > 1:
                        v += f" @({a['m0']},{a['e0']:g})"
                        if not multi_het and (
                                a.get("het") or "homogeneous") != "homogeneous":
                            v += f"/{a['het']}"
                    parts.append(v)
                cells.append("; ".join(parts))
            lines.append(f"| {_fmt_pref(p)} | " + " | ".join(cells) + " |")
    return "\n".join(lines)
