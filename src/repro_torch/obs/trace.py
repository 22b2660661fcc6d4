"""Dual-clock span tracer (copy of ``repro.obs.trace``; the profiler
annotations per span are an NVTX range instead of a JAX trace annotation,
and a ``torch.profiler`` range while a profiler records).

A :class:`Span` carries two time bases at once:

* **wall clock** — ``time.perf_counter()`` at enter/exit, i.e. what the
  host actually spent (JAX dispatch, compilation, python orchestration);
* **virtual clock** — the event runtime's simulated federated time
  (``VirtualClock.now``), i.e. what the *modelled* system spent.

The pair is what makes sweep traces legible: a lane whose virtual round
took 40 s of simulated client time may cost 3 ms of host time inside a
pack of 16 lanes — both numbers end up on adjacent Perfetto tracks.

Zero-cost-when-disabled contract: ``Tracer.span`` returns the shared
:data:`NULL_SPAN` (a no-op context manager with ``__slots__ = ()``) when
the tracer is off and no ``torch.profiler`` records (a bare profiler
range with the same interface when one does), and ``record``/``counter``
return immediately.  The tracer never touches rngs or training values,
so enabling it cannot perturb results (bit-parity is pinned in
tests/test_torch_obs.py).

This module imports nothing from the rest of ``repro_torch`` so every layer —
runtime, experiments, federated, launch — can instrument freely without
import cycles.
"""

from __future__ import annotations

import functools
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from torch._C._autograd import _profiler_enabled
from torch.autograd import profiler as _profiler


@dataclass
class Span:
    """One traced interval on (up to) two clocks.

    ``virtual_t0/t1`` are ``None`` for host-only spans (e.g. a pack
    compile); ``wall_t0 == wall_t1`` for retroactively recorded
    virtual-only intervals (e.g. an in-flight client window known once
    its arrival event pops).
    """

    name: str
    phase: Optional[str] = None
    trial: Optional[str] = None
    lane: Optional[int] = None
    round_idx: Optional[int] = None
    wall_t0: float = 0.0
    wall_t1: float = 0.0
    virtual_t0: Optional[float] = None
    virtual_t1: Optional[float] = None
    attrs: Dict[str, Any] = field(default_factory=dict)

    @property
    def wall_dur(self) -> float:
        return self.wall_t1 - self.wall_t0

    @property
    def virtual_dur(self) -> Optional[float]:
        if self.virtual_t0 is None or self.virtual_t1 is None:
            return None
        return self.virtual_t1 - self.virtual_t0


class _NullSpan:
    """Shared do-nothing span handed out while tracing is disabled."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_value, tb):
        return False

    def set(self, **attrs):
        return self


NULL_SPAN = _NullSpan()


class _ProfiledSpan:
    """A ``record_function`` range with :data:`NULL_SPAN`'s interface (a
    no-op ``set``): what ``Tracer.span`` hands out while the tracer is off
    and a ``torch.profiler`` records."""

    __slots__ = ("_range",)

    def __init__(self, name: str):
        self._range = _profiler.record_function(name)

    def __enter__(self):
        self._range.__enter__()
        return self

    def __exit__(self, exc_type, exc_value, tb):
        return self._range.__exit__(exc_type, exc_value, tb)

    def set(self, **attrs):
        return self


class _LiveSpan:
    """Context manager that stamps both clocks and appends to the tracer."""

    __slots__ = ("_tracer", "_span", "_clock", "_annotations")

    def __init__(self, tracer: "Tracer", span: Span, clock, annotations):
        self._tracer = tracer
        self._span = span
        self._clock = clock
        self._annotations = annotations

    def set(self, **attrs):
        self._span.attrs.update(attrs)
        return self

    def __enter__(self):
        if self._clock is not None:
            self._span.virtual_t0 = self._clock.now
        for ann in self._annotations:
            ann.__enter__()
        self._span.wall_t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc_value, tb):
        self._span.wall_t1 = time.perf_counter()
        for ann in reversed(self._annotations):
            ann.__exit__(exc_type, exc_value, tb)
        if self._clock is not None:
            self._span.virtual_t1 = self._clock.now
        self._tracer.spans.append(self._span)
        return False


class _NvtxRange:
    """One NVTX range around a span (``torch.cuda.nvtx``)."""

    __slots__ = ("_name",)

    def __init__(self, name: str):
        self._name = name

    def __enter__(self):
        import torch.cuda.nvtx as nvtx
        nvtx.range_push(self._name)
        return self

    def __exit__(self, exc_type, exc_value, tb):
        import torch.cuda.nvtx as nvtx
        nvtx.range_pop()
        return False


class Tracer:
    """Process-wide span collector (singleton at :data:`tracer`).

    ``counters`` holds ``(name, wall_t, value)`` samples for Chrome
    "C"-phase counter tracks (e.g. the global ``t_sim`` watermark).
    """

    def __init__(self):
        self.enabled = False
        self.spans: List[Span] = []
        self.counters: List[Tuple[str, float, float]] = []
        self._annotation_cls: Optional[Callable] = None

    def enable(self, nvtx: bool = False, reset: bool = True):
        if reset:
            self.clear()
        self._annotation_cls = None
        if nvtx:
            try:                       # a CPU build of torch has no NVTX
                import torch.cuda.nvtx as _nvtx
                _nvtx.range_push("probe")
                _nvtx.range_pop()
                self._annotation_cls = _NvtxRange
            except (ImportError, RuntimeError):
                # profiler annotations unavailable -> spans still work
                self._annotation_cls = None
        self.enabled = True

    def disable(self):
        self.enabled = False
        self._annotation_cls = None

    def clear(self):
        self.spans = []
        self.counters = []

    def span(self, name: str, *, phase: Optional[str] = None,
             trial: Optional[str] = None, lane: Optional[int] = None,
             round_idx: Optional[int] = None, clock=None, **attrs):
        """Open a span; pass ``clock`` (an object with ``.now``) to also
        stamp virtual time at enter/exit.  While a ``torch.profiler``
        records, the span is also a range on its timeline, recorded or
        not."""
        if not self.enabled:
            return _ProfiledSpan(name) if _profiler_enabled() else NULL_SPAN
        sp = Span(name=name, phase=phase, trial=trial, lane=lane,
                  round_idx=round_idx, attrs=attrs)
        anns = ()
        if self._annotation_cls is not None:
            anns = (self._annotation_cls(name),)
        if _profiler_enabled():
            anns = anns + (_profiler.record_function(name),)
        return _LiveSpan(self, sp, clock, anns)

    def record(self, name: str, *,
               wall: Optional[Tuple[float, float]] = None,
               virtual: Optional[Tuple[float, float]] = None,
               phase: Optional[str] = None, trial: Optional[str] = None,
               lane: Optional[int] = None, round_idx: Optional[int] = None,
               **attrs):
        """Append a completed span whose bounds are already known — the
        way virtual intervals are traced, since their extent only exists
        after the clock has advanced past them."""
        if not self.enabled:
            return
        now = time.perf_counter()
        w0, w1 = wall if wall is not None else (now, now)
        v0, v1 = virtual if virtual is not None else (None, None)
        self.spans.append(Span(name=name, phase=phase, trial=trial,
                               lane=lane, round_idx=round_idx,
                               wall_t0=w0, wall_t1=w1,
                               virtual_t0=v0, virtual_t1=v1, attrs=attrs))

    def counter(self, name: str, value, wall_t: Optional[float] = None):
        if not self.enabled:
            return
        t = time.perf_counter() if wall_t is None else wall_t
        self.counters.append((name, t, float(value)))


tracer = Tracer()


def traced(name: str, phase: Optional[str] = None):
    """Method decorator: wrap calls in a span attributed to the owner's
    ``trace_label`` (the runtime sets this to the trial key).  When the
    tracer is off and no profiler records, the only cost is an attribute
    and a flag check."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(self, *args, **kwargs):
            if not tracer.enabled and not _profiler_enabled():
                return fn(self, *args, **kwargs)
            with tracer.span(name, phase=phase,
                             trial=getattr(self, "trace_label", None)):
                return fn(self, *args, **kwargs)
        return wrapper
    return deco
