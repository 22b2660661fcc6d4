"""Metrics registry: phase timers, counters, gauges, histograms, series
(copy of ``repro.obs.metrics``).

Two tiers with different always-on guarantees:

* **Phase timers** (``phase``/``phase_add``/``phase_seconds``/
  ``phase_call_count``) are always on — they are the backing store for
  the ``repro_torch.perf`` shim, whose ``timed("train")``/``timed("eval")``
  split the benchmarks read.  Overhead is one ``perf_counter`` pair and
  two dict updates per phase.
* **Observability metrics** (``inc``/``gauge``/``observe``/``sample``)
  are recorded unconditionally by this module but every call site gates
  on ``obs.enabled()`` first, so with tracing off no metric call is even
  reached — that is the zero-cost contract, pinned in tests/test_torch_obs.py.

``sample`` feeds the metrics JSONL stream (``obs.export``): a bounded
list of ``{"name", "value", "step", ...tags}`` rows for time-series like
live-lane occupancy and per-bucket pack widths.  ``observe`` feeds
histograms (staleness, store write latency) summarized at export time.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

# Safety valve so a pathological run cannot grow the series list without
# bound; 1M rows is far beyond any smoke/bench sweep (which emit ~1e3).
SERIES_LIMIT = 1_000_000


def _percentile(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank percentile on an already-sorted list."""
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, max(0, int(round(q * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]


class MetricsRegistry:
    """Process-wide metric store (singleton at :data:`registry`)."""

    def __init__(self):
        self._phase_s: Dict[str, float] = {}
        self._phase_calls: Dict[str, int] = {}
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        self._hists: Dict[str, List[float]] = {}
        self._series: List[Dict[str, Any]] = []

    # ---- phase timers (always on; repro_torch.perf delegates here) ----------

    def phase_add(self, name: str, seconds: float):
        self._phase_s[name] = self._phase_s.get(name, 0.0) + seconds
        self._phase_calls[name] = self._phase_calls.get(name, 0) + 1

    @contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.phase_add(name, time.perf_counter() - t0)

    def phase_seconds(self, name: str) -> float:
        return self._phase_s.get(name, 0.0)

    def phase_call_count(self, name: str) -> int:
        return self._phase_calls.get(name, 0)

    def phase_snapshot(self) -> Dict[str, float]:
        return dict(self._phase_s)

    def phase_calls_snapshot(self) -> Dict[str, int]:
        return dict(self._phase_calls)

    # ---- observability metrics (call sites gate on obs.enabled()) -----

    def inc(self, name: str, value: float = 1.0):
        self._counters[name] = self._counters.get(name, 0.0) + value

    def gauge(self, name: str, value: float):
        self._gauges[name] = float(value)

    def observe(self, name: str, value: float):
        self._hists.setdefault(name, []).append(float(value))

    def sample(self, name: str, value: float, step: Optional[int] = None,
               **tags):
        if len(self._series) >= SERIES_LIMIT:
            return
        row: Dict[str, Any] = {"name": name, "value": float(value)}
        if step is not None:
            row["step"] = int(step)
        if tags:
            row.update(tags)
        self._series.append(row)

    # ---- accessors ----------------------------------------------------

    def counter_value(self, name: str) -> float:
        return self._counters.get(name, 0.0)

    def counters(self) -> Dict[str, float]:
        return dict(self._counters)

    def gauges(self) -> Dict[str, float]:
        return dict(self._gauges)

    def series(self, name: Optional[str] = None) -> List[Dict[str, Any]]:
        if name is None:
            return list(self._series)
        return [r for r in self._series if r["name"] == name]

    def histogram_summary(self, name: str) -> Dict[str, float]:
        vals = sorted(self._hists.get(name, []))
        if not vals:
            return {"count": 0}
        return {
            "count": len(vals),
            "min": vals[0],
            "max": vals[-1],
            "mean": sum(vals) / len(vals),
            "p50": _percentile(vals, 0.50),
            "p90": _percentile(vals, 0.90),
            "p99": _percentile(vals, 0.99),
        }

    def histograms(self) -> Dict[str, Dict[str, float]]:
        return {n: self.histogram_summary(n) for n in sorted(self._hists)}

    def snapshot(self) -> Dict[str, Any]:
        """Everything at once — what the benchmark and exporters read."""
        return {
            "phases": self.phase_snapshot(),
            "phase_calls": self.phase_calls_snapshot(),
            "counters": self.counters(),
            "gauges": self.gauges(),
            "histograms": self.histograms(),
            "n_series": len(self._series),
        }

    def reset(self):
        self._phase_s.clear()
        self._phase_calls.clear()
        self._counters.clear()
        self._gauges.clear()
        self._hists.clear()
        self._series.clear()


registry = MetricsRegistry()
