"""Observability subsystem: dual-clock span tracing + metrics (copy of
``repro.obs``; its profiler hooks open NVTX ranges and, while a
``torch.profiler`` records, ``record_function`` ranges here).

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

The LM steps' layers open named ranges (``range`` around a block,
``ranged`` around a whole function, and the names below):
live exactly while a ``torch.profiler`` records, so that each kernel on
its timeline falls under the innermost range open at its launch, and the
shared no-op span otherwise (one flag check a site).  Every ``obs.span``
is such a range too while a profiler records.  Pinned in
tests/test_torch_ranges.py.

Typical wiring (what ``launch/sweep.py --trace`` does):

    from repro_torch import obs
    obs.enable()                       # optionally nvtx=True
    ... run the sweep ...
    from repro_torch.obs.export import write_chrome_trace, write_metrics_jsonl
    write_chrome_trace("out.trace.json")
    write_metrics_jsonl("out.metrics.jsonl")
"""

from __future__ import annotations

import functools

from torch._C._autograd import _profiler_enabled
from torch.autograd import profiler as _profiler

from repro_torch.obs import metrics
from repro_torch.obs.metrics import registry
from repro_torch.obs.trace import NULL_SPAN, Span, Tracer, traced, tracer

# The program's profiler ranges, each opened by the function that does the
# work (a kernel counts under the innermost one open at its launch):
PREFILL_STEP = "prefill_step"    # launch/steps.py, the prefill step's body
SERVE_STEP = "serve_step"        # launch/steps.py, the serve step's body
EMBED = "embed"                  # lm._embed_tokens
NORM = "norm"                    # common.rmsnorm
QKV_PROJ = "qkv_proj"            # attention._project_qkv
ROPE = "rope"                    # common.apply_rope (inside qkv_proj)
ATTN_CORE = "attn_core"          # attention._attend; decode's f32 cast,
                                 # scores, mask, softmax and PV
CACHE_WRITE = "cache_write"      # attention._write_slots, decode's slot
                                 # writes, stacked._into_stack
OUT_PROJ = "out_proj"            # attention._out_proj
MLP = "mlp"                      # ffn.mlp
MOE_ROUTER = "moe_router"        # ffn._route
MOE_EXPERT_PRODUCTS = "moe_expert_products"   # the experts' products
MOE_COMBINE = "moe_combine"      # the gate-weighted combine of the experts
UNEMBED = "unembed"              # lm._unembed
SLSTM_STEP_LOOP = "slstm_step_loop"           # xlstm.slstm_sequence's loop
RANGES = (PREFILL_STEP, SERVE_STEP, EMBED, NORM, QKV_PROJ, ROPE, ATTN_CORE,
          CACHE_WRITE, OUT_PROJ, MLP, MOE_ROUTER, MOE_EXPERT_PRODUCTS,
          MOE_COMBINE, UNEMBED, SLSTM_STEP_LOOP)


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
    tracing is disabled and no profiler records."""
    return tracer.span(name, **kw)


def range(name: str):      # noqa: A001 -- ``obs.range`` at the sites
    """One of the program's named ranges (``RANGES``) on the profiler's
    timeline alone, no span of the tracer's: a ``record_function`` while a
    ``torch.profiler`` records, else the shared :data:`NULL_SPAN` at the
    cost of one flag check."""
    if not _profiler_enabled():
        return NULL_SPAN
    return _profiler.record_function(name)


def ranged(name: str):
    """Decorator: each call of the function as the range ``name`` (see
    ``range``); with no profiler recording, the function is called
    directly after one flag check."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not _profiler_enabled():
                return fn(*args, **kwargs)
            with _profiler.record_function(name):
                return fn(*args, **kwargs)
        return wrapper
    return deco


def record(name: str, **kw):
    """Record an already-bounded span retroactively (e.g. a virtual-time
    window known only after the clock advanced); no-op when disabled."""
    tracer.record(name, **kw)


def counter(name: str, value):
    """Sample a wall-clock-stamped counter track value (e.g. ``t_sim``);
    no-op when disabled."""
    tracer.counter(name, value)
