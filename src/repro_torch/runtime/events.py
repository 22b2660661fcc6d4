"""Virtual-clock event queues for the heterogeneous FL runtime.

A tiny discrete-event core: events carry a virtual timestamp and are popped
in time order with a monotonically increasing sequence number breaking ties,
so two events at the same instant always replay in push order — the whole
simulation is a pure function of its seeds.  The clock never goes backwards;
popping an event advances it.

Two queue flavors:

``EventQueue``       — one trial's events, keyed (time, seq).  Drives the
                       standalone ``EventDrivenRuntime`` loop.
``MergedEventQueue`` — events of MANY concurrent trials in one heap, keyed
                       (time, trial_ord, seq).  Drives the vectorized
                       async/buffered sweep engine
                       (repro.experiments.runner), which packs pending
                       client completions across trials into one cohort.
                       Cross-trial ties at the same instant break by the
                       trial's stable ordinal (assigned from sorted trial
                       keys), and within a trial by the per-trial push
                       sequence — the SAME tie order the trial's standalone
                       ``EventQueue`` would produce, which is what makes a
                       merged re-run (or a resume) replay each trial's
                       events bit-identically.

Copy of ``repro.runtime.events``; the port imports nothing of ``repro``.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Dict, List

# event kinds
ARRIVAL = "arrival"          # a client's update reaches the server
DROPOUT = "dropout"          # a client died mid-round; its work is lost
FAILURE = "failure"          # the dispatch was consumed but the update never
                             # returns: the client (or its link) hard-failed.
                             # Distinct from DROPOUT — a dropout's work is
                             # merely lost at the cutoff, a failure triggers
                             # the coordinator's retry/reassignment policy
                             # (EventDrivenRuntime.handle_failure).


@dataclass(order=True)
class Event:
    time: float
    seq: int
    kind: str = field(compare=False)
    client_id: int = field(compare=False, default=-1)


class VirtualClock:
    """Monotonic simulated time."""

    def __init__(self):
        self._now = 0.0

    @property
    def now(self) -> float:
        return self._now

    def advance_to(self, t: float):
        assert t >= self._now - 1e-12, f"clock went backwards: {t} < {self._now}"
        self._now = max(self._now, t)


class EventQueue:
    """One trial's pending events, popped in (time, push-order) order."""

    def __init__(self):
        self._heap: List[Event] = []
        self._seq = 0

    def push(self, time: float, kind: str, client_id: int = -1) -> Event:
        ev = Event(time=float(time), seq=self._seq, kind=kind,
                   client_id=client_id)
        self._seq += 1
        heapq.heappush(self._heap, ev)
        return ev

    def pop(self) -> Event:
        return heapq.heappop(self._heap)

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)


# ---------------------------------------------------------------------------
# merged multi-trial queue (vectorized async/buffered sweeps)
# ---------------------------------------------------------------------------

@dataclass(order=True)
class TaggedEvent:
    """An event tagged with the trial it belongs to.  Ordering is total and
    deterministic: (time, trial_ord, seq) — cross-trial ties break by the
    trial's stable ordinal, within-trial ties by per-trial push order
    (identical to what the trial's own ``EventQueue`` would do, so merged
    execution replays each trial's event order exactly)."""
    time: float
    trial_ord: int
    seq: int
    kind: str = field(compare=False)
    client_id: int = field(compare=False, default=-1)


class MergedEventQueue:
    """One heap spanning all live trials of a vectorized event-driven sweep.

    ``push`` stamps the event with the trial's own monotone sequence
    counter; ``requeue`` re-inserts a popped event UNCHANGED (used by the
    sweep runner to defer a trial's next event while an earlier arrival of
    the same trial is still training in the packed cohort).  ``count_for``
    answers the per-trial emptiness question the engine's dispatch deadlock
    guard asks."""

    def __init__(self):
        self._heap: List[TaggedEvent] = []
        self._seq: Dict[int, int] = {}
        self._count: Dict[int, int] = {}

    def push(self, trial_ord: int, time: float, kind: str,
             client_id: int = -1) -> TaggedEvent:
        seq = self._seq.get(trial_ord, 0)
        self._seq[trial_ord] = seq + 1
        ev = TaggedEvent(time=float(time), trial_ord=trial_ord, seq=seq,
                         kind=kind, client_id=client_id)
        self._count[trial_ord] = self._count.get(trial_ord, 0) + 1
        heapq.heappush(self._heap, ev)
        return ev

    def pop(self) -> TaggedEvent:
        ev = heapq.heappop(self._heap)
        self._count[ev.trial_ord] -= 1
        return ev

    def requeue(self, ev: TaggedEvent):
        """Put a popped event back with its original (time, trial_ord, seq)
        key — heap order is restored exactly."""
        self._count[ev.trial_ord] += 1
        heapq.heappush(self._heap, ev)

    def drop_trial(self, trial_ord: int) -> int:
        """Remove every pending event of a retired trial and return how
        many were dropped.  The continuous-batching scheduler retires a
        lane the moment its trial reaches target; without this the heap
        would carry the retired trial's traffic forever (each stale event
        popped and skipped one macro-step at a time).  The per-trial seq
        counter is deliberately kept: ordinals are never reused, and a
        monotone seq is what makes the (time, trial_ord, seq) order
        total."""
        n = self._count.get(trial_ord, 0)
        if n:
            self._heap = [ev for ev in self._heap
                          if ev.trial_ord != trial_ord]
            heapq.heapify(self._heap)
            self._count[trial_ord] = 0
        return n

    def count_for(self, trial_ord: int) -> int:
        return self._count.get(trial_ord, 0)

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)


class TrialQueueView:
    """``EventQueue``-shaped facade binding ONE trial onto a
    ``MergedEventQueue``: the runtime engine's dispatch/fill helpers push
    through it without knowing they are part of a merged sweep, and its
    truthiness answers 'does THIS trial still have queued events?' (the
    question the dispatch deadlock guard asks), not global emptiness."""

    def __init__(self, merged: MergedEventQueue, trial_ord: int):
        self.merged = merged
        self.trial_ord = trial_ord

    def push(self, time: float, kind: str, client_id: int = -1):
        return self.merged.push(self.trial_ord, time, kind, client_id)

    def __len__(self) -> int:
        return self.merged.count_for(self.trial_ord)

    def __bool__(self) -> bool:
        return self.merged.count_for(self.trial_ord) > 0
