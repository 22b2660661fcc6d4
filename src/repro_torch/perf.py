"""Wall-clock phase counters: the shim over ``repro_torch.obs`` (copy of
``repro.perf``).

The counters live in the observability metrics registry
(``repro_torch.obs.metrics.registry``), so phase timings, span traces and
sweep metrics share one store and one ``reset()``.  The surface is the
reference's: ``timed``/``add``/``seconds``/``calls``/``snapshot``/
``reset``.

Counters accumulate host wall-clock around the timed block.  CUDA work is
asynchronous, so a phase's device time is attributed to the phase that
eventually waits on its results: training and evaluation blocks both end
in host reads (``.cpu()``, ``float``), which keeps the train/eval/other
split honest at benchmark granularity.  Not thread-safe; the sweep
engines are single-threaded.

Note ``reset()`` clears the *whole* registry (phases and observability
metrics), matching the benchmark's expectation that a reset starts a
clean measurement window.
"""

from __future__ import annotations

from typing import Dict

from repro_torch.obs.metrics import registry as _registry


def add(name: str, seconds: float):
    _registry.phase_add(name, seconds)


def timed(name: str):
    """Accumulate the block's wall-clock under ``name`` (context manager)."""
    return _registry.phase(name)


def seconds(name: str) -> float:
    return _registry.phase_seconds(name)


def calls(name: str) -> int:
    return _registry.phase_call_count(name)


def snapshot() -> Dict[str, float]:
    return _registry.phase_snapshot()


def calls_snapshot() -> Dict[str, int]:
    """Per-phase call counts — exported alongside seconds in BENCH json."""
    return _registry.phase_calls_snapshot()


def reset():
    _registry.reset()
