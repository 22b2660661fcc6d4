"""Observability subsystem: dual-clock span tracing + metrics (copy of
``repro.obs``; its one profiler hook opens NVTX ranges here).

The paper's whole argument is that hyper-parameter decisions must be
driven by *measured* system overhead — so the sweep engine needs to be
measurable itself.  This package provides:

  ``trace``   — a span tracer recording dual clocks per span (virtual
                simulation time from the event runtime's clock AND host
                wall-clock), attributed to trial/lane/round/phase.
  ``metrics`` — a registry of counters/gauges/histograms/series (lane
                occupancy, pack widths, pow2-padding waste, staleness,
                dropout/straggler counts, cache hit rates) that also backs
                the ``repro_torch.perf`` phase-timer shim.
  ``export``  — Chrome trace-event JSON (loadable in Perfetto: one track
                per trial lane on both clocks), a metrics JSONL stream,
                and the checked-in trace-schema validator.

Contract: tracing is **zero-cost when disabled** (every instrumentation
site either checks ``obs.enabled()`` or goes through ``obs.span``, which
returns a shared no-op context manager when the tracer is off) and
**bit-parity-neutral when enabled** — spans and metrics only read clocks
and counts, never an rng or a float that feeds training.  Both halves are
pinned in tests/test_torch_obs.py.

Typical wiring (what ``launch/sweep.py --trace`` does):

    from repro_torch import obs
    obs.enable()                       # optionally nvtx=True
    ... run the sweep ...
    from repro_torch.obs.export import write_chrome_trace, write_metrics_jsonl
    write_chrome_trace("out.trace.json")
    write_metrics_jsonl("out.metrics.jsonl")
"""

from __future__ import annotations

from repro_torch.obs import metrics
from repro_torch.obs.metrics import registry
from repro_torch.obs.trace import NULL_SPAN, Span, Tracer, traced, tracer


def enabled() -> bool:
    """Is the process-wide tracer on?  Instrumentation sites in hot loops
    gate on this before building span/metric arguments."""
    return tracer.enabled


def enable(nvtx: bool = False, reset: bool = True):
    """Turn tracing + metric collection on.  ``nvtx=True`` additionally
    opens an NVTX range per span (``torch.cuda.nvtx``), so a device
    profile taken alongside lines up with our spans; where PyTorch has no
    NVTX (a CPU build) the spans are recorded without it."""
    tracer.enable(nvtx=nvtx, reset=reset)


def disable():
    tracer.disable()


def span(name: str, **kw):
    """Context-managed span (see ``Tracer.span``); a shared no-op when
    tracing is disabled."""
    return tracer.span(name, **kw)


def record(name: str, **kw):
    """Record an already-bounded span retroactively (e.g. a virtual-time
    window known only after the clock advanced); no-op when disabled."""
    tracer.record(name, **kw)


def counter(name: str, value):
    """Sample a wall-clock-stamped counter track value (e.g. ``t_sim``);
    no-op when disabled."""
    tracer.counter(name, value)
