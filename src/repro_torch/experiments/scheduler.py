"""Continuous-batching trial scheduler: paged lane allocation over the
sweep engines (counterpart of ``repro.experiments.scheduler``).

The fixed-set sweep (``run_vectorized``) packs T trials and lets lanes go
idle as trials hit their accuracy targets at different rounds — fine for a
one-shot grid, wrong for the serving shape the paper implies, where tuning
trials arrive as an open-ended *stream* (population-based tuning, adaptive
HPO, many tenants sweeping at once) and the hardware should stay full.
This module turns the sweep engines into a trial-serving daemon, borrowing
the page-table idiom of LLM serving (vLLM-style continuous batching):

  ``LanePool``       — the page table over the stacked trial axis: a fixed
                       capacity of lanes ("pages"), a min-index free list,
                       and a bidirectional lane<->trial-key mapping.  A
                       lane is allocated at admission and released the
                       moment its trial retires — never reused while held,
                       always the lowest free index, so allocation is
                       deterministic given the admission sequence.
  ``TrialQueue``     — the pending work: an in-order FIFO of ``TrialSpec``
                       seeded from a grid and/or fed by a watched JSONL
                       submissions file (one spec dict per line, appended
                       by any writer at any time).  Deduplicates by trial
                       key and skips keys already completed in the result
                       store (resume).
  ``TrialScheduler`` — the serving loop: admit from the queue into free
                       lanes, advance every live sync trial one packed
                       virtual round (``_sync_round_step``) and every live
                       async/buffered trial one merged-queue macro-step
                       (``_EventEngine.macro_step``), retire finished
                       (release the lane, stream the result to the store),
                       repeat.  ``drain()`` runs until queue and pool are
                       both empty.

Parity contract (pinned in tests/test_torch_serve.py): every trial
admitted through the scheduler gives the FedTune (M, E) trajectory, cost
totals and dispatch/staleness logs of an independent ``FLServer.run()``,
and on the CPU its accuracies too.  Admission and retirement change
*which* trials pack together in a cohort, never a trial's own decisions,
because each trial's rngs and virtual clock are private.  Params are not
bit-identical to a standalone run (a batched product does not give each
lane the bits of a single product), so on the card an accuracy may differ
by an eval point (ROADMAP.md section 3, departure 7).  A trial admitted
mid-flight starts its virtual clock at 0 exactly as a standalone run
would; the pool's wall-clock interleaving is not part of any trial's
result.  A drain's store is the same whatever lanes freed when, and after
a kill and a restore from the last snapshot it is the uninterrupted
drain's, row for row (``wall`` aside).

Every entry point runs on ``device`` (default ``cuda``) and takes an
optional ``init_params(spec) -> numpy tree``, as the runner does.

Observability: ``admit``/``retire`` instant spans (wall clock, per-trial
track), a ``pool_occupancy`` gauge sampled every scheduler step, plus
``queue_depth`` and ``trials_admitted``/``trials_retired`` counters.
"""

from __future__ import annotations

import heapq
import json
import os
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Union

from repro_torch import obs
from repro_torch.device import resolve_device
from repro_torch.experiments.grid import TrialSpec, spec_from_dict
from repro_torch.experiments.runner import (InitFn, TrialResult,
                                            _check_pack, _EventEngine,
                                            _make_live, _sync_round_step,
                                            _to_result)


class LanePool:
    """Page table over the stacked trial axis: ``capacity`` lanes, a
    min-index free list, and the lane<->trial-key mapping.

    Allocation invariants (tested in tests/test_torch_serve.py):
    a lane is held by at most one trial and a trial holds at most one
    lane; ``alloc`` always hands out the LOWEST free index (deterministic
    given the admission/retirement sequence); ``release`` returns the
    lane to the free list immediately.
    """

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError(f"LanePool capacity must be >= 1, "
                             f"got {capacity}")
        self.capacity = capacity
        self._free: List[int] = list(range(capacity))   # min-heap
        self._page: Dict[int, str] = {}                 # lane -> trial key
        self._lane: Dict[str, int] = {}                 # trial key -> lane

    @property
    def n_live(self) -> int:
        return len(self._page)

    @property
    def n_free(self) -> int:
        return len(self._free)

    def occupancy(self) -> float:
        return len(self._page) / self.capacity

    def alloc(self, key: str) -> int:
        """Assign the lowest free lane to ``key``; raises when the pool is
        full or the key already holds a lane (double admission is a caller
        bug, not a condition to paper over)."""
        if key in self._lane:
            raise ValueError(f"trial {key!r} already holds lane "
                             f"{self._lane[key]}")
        if not self._free:
            raise ValueError(f"lane pool is full ({self.capacity} lanes); "
                             "check n_free before alloc")
        lane = heapq.heappop(self._free)
        self._page[lane] = key
        self._lane[key] = lane
        return lane

    def release(self, key: str) -> int:
        """Free the lane held by ``key`` (KeyError if it holds none) and
        return its index."""
        lane = self._lane.pop(key)
        del self._page[lane]
        heapq.heappush(self._free, lane)
        return lane

    def lane_of(self, key: str) -> Optional[int]:
        return self._lane.get(key)

    def key_of(self, lane: int) -> Optional[str]:
        return self._page.get(lane)

    def live_mask(self) -> List[bool]:
        """Per-lane occupancy, index == lane — the mask the pack/eval
        shapes are keyed off."""
        return [lane in self._page for lane in range(self.capacity)]

    def live_keys(self) -> List[str]:
        """Held trial keys in lane order (deterministic)."""
        return [self._page[lane] for lane in sorted(self._page)]


class TrialQueue:
    """Pending trials, admitted strictly in submission order.

    Seeded from an in-memory grid (``specs``) and/or fed from a watched
    JSONL submissions file: each ``poll()`` reads any COMPLETE new lines
    (a half-written tail is left for the next poll — same truncated-tail
    tolerance as the result store) and submits one spec per line.  A line
    is either a bare ``TrialSpec.to_dict()`` object or a record with a
    ``"spec"`` field (so result-store records can be piped back in as
    resubmissions).  Submissions deduplicate by trial key against
    everything ever queued AND against ``completed`` keys (the resume
    set); rejected submissions are counted, never fatal.
    """

    def __init__(self, specs: Sequence[TrialSpec] = (),
                 watch_path: Optional[str] = None,
                 completed: Iterable[str] = ()):
        self._pending: deque = deque()
        self._seen: set = set()          # every key ever queued
        self._done: set = set(completed)
        self.watch_path = watch_path
        self._watch_pos = 0
        self.n_submitted = 0
        self.n_skipped = 0               # dupes + already-completed
        for s in specs:
            self.submit(s)

    def __len__(self) -> int:
        return len(self._pending)

    def __bool__(self) -> bool:
        return bool(self._pending)

    def submit(self, spec: TrialSpec) -> bool:
        """Queue one trial; False (counted, not fatal) when its key was
        already queued or completed."""
        key = spec.key()
        if key in self._seen or key in self._done:
            self.n_skipped += 1
            return False
        spec.validate()
        self._seen.add(key)
        self._pending.append(spec)
        self.n_submitted += 1
        return True

    def pop(self) -> TrialSpec:
        return self._pending.popleft()

    def mark_done(self, key: str):
        self._done.add(key)

    def poll(self) -> int:
        """Read new complete lines from the watched submissions file and
        submit them; returns how many were accepted.  Byte-positional:
        only ever reads forward, so a writer appending concurrently is
        safe and a torn final line is retried next poll."""
        if self.watch_path is None or not os.path.exists(self.watch_path):
            return 0
        with open(self.watch_path, "rb") as f:
            f.seek(self._watch_pos)
            chunk = f.read()
        n = 0
        consumed = 0
        for raw in chunk.split(b"\n")[:-1]:   # complete lines only
            consumed += len(raw) + 1
            line = raw.decode("utf-8", errors="replace").strip()
            if not line:
                continue
            try:
                d = json.loads(line)
                if not isinstance(d, dict):
                    raise ValueError("submission line must be a JSON object")
                spec = spec_from_dict(d.get("spec") or d)
                if self.submit(spec):
                    n += 1
            except (ValueError, TypeError, KeyError) as e:
                # a malformed submission must not kill the daemon
                self.n_skipped += 1
                print(f"scheduler: skipping malformed submission line: {e}",
                      flush=True)
        self._watch_pos += consumed
        return n


@dataclass
class ServeStats:
    """One drain's bookkeeping: occupancy is averaged over scheduler
    steps, so a pool kept full by continuous admission scores ~1.0 where
    a fixed pack decays toward 1/capacity as trials finish."""
    admitted: int = 0
    retired: int = 0
    steps: int = 0
    occupancy_sum: float = 0.0
    admission_log: List[tuple] = field(default_factory=list)  # (key, lane)

    @property
    def mean_occupancy(self) -> float:
        return self.occupancy_sum / self.steps if self.steps else 0.0


class TrialScheduler:
    """The serving loop: admit -> step every live trial -> retire.

    Sync trials advance one packed virtual round per scheduler step
    (``_sync_round_step``), async/buffered trials one merged-queue
    macro-step (``_EventEngine.macro_step``); both key their shapes
    off the pool's live set, never an initial T.  Retirement releases the
    lane and the freed slot is refilled from the queue at the top of the
    NEXT step — admission order is the queue order, regardless of which
    lanes freed when (tested in tests/test_torch_serve.py).

    ``max_results`` stops the drain once AT LEAST that many trials have
    retired this invocation (a soft limit: the crossing step may retire
    one trial per live lane) — the CI smoke job uses it to simulate a
    killed daemon mid-drain; a fresh scheduler over the same store
    resumes past the retired keys.
    """

    def __init__(self, queue: TrialQueue, *, max_lanes: int = 4,
                 store=None, pack: str = "batched",
                 on_result: Optional[Callable[[TrialResult], None]] = None,
                 verbose: bool = False,
                 snapshot_path: Optional[str] = None,
                 snapshot_every: int = 1, device=None,
                 init_params: InitFn = None):
        _check_pack(pack)
        self.device = resolve_device(device)
        self.init_params = init_params
        self.queue = queue
        self.pool = LanePool(max_lanes)
        self.store = store
        self.on_result = on_result
        self.verbose = verbose
        self.snapshot_path = snapshot_path
        self.snapshot_every = max(1, int(snapshot_every))
        self._pack = pack
        self._ev = _EventEngine(self.device, init_params)
        self._sync_live: List = []
        self._event_live: List = []
        self._sync_steps = 0
        self.stats = ServeStats()
        self.results: List[TrialResult] = []
        self.duplicates_suppressed = 0
        self._sync_engine = f"serve-sync/{self._pack}"
        self._event_engine = "serve-events/batched"

    # -- admission ------------------------------------------------------
    def admit_pending(self) -> int:
        """Poll the watched submissions file, then admit queued trials
        into free lanes (queue order, lowest free lane first)."""
        self.queue.poll()
        n = 0
        while self.queue and self.pool.n_free:
            spec = self.queue.pop()
            lane = self.pool.alloc(spec.key())
            self.stats.admitted += 1
            self.stats.admission_log.append((spec.key(), lane))
            if obs.enabled():
                obs.registry.inc("trials_admitted")
                obs.record("admit", phase="admit", trial=spec.key(),
                           lane=lane, step=self.stats.steps,
                           queue_depth=len(self.queue))
            if spec.mode == "sync":
                self._sync_live.append(_make_live(spec, self.device,
                                                  self.init_params))
            else:
                self._event_live.append(self._ev.admit(spec))
            if self.verbose:
                print(f"  serve: admit {spec.key()} -> lane {lane} "
                      f"({self.pool.n_live}/{self.pool.capacity} live)",
                      flush=True)
            n += 1
        return n

    # -- retirement -----------------------------------------------------
    def _retire(self, spec: TrialSpec, result: TrialResult):
        lane = self.pool.release(spec.key())
        self.queue.mark_done(spec.key())
        self.stats.retired += 1
        if obs.enabled():
            obs.registry.inc("trials_retired")
            obs.record("retire", phase="retire", trial=spec.key(),
                       lane=lane, step=self.stats.steps,
                       reached=result.reached, rounds=result.rounds)
        if self.store is not None:
            if self.store.is_completed(spec.key()):
                # restored-and-replayed macro-step: this trial retired
                # during the replayed step BEFORE the kill, so its row is
                # already in the store — appending again would duplicate it
                self.duplicates_suppressed += 1
            else:
                self.store.append(result.to_record())
        self.results.append(result)
        if self.on_result is not None:
            self.on_result(result)
        if self.verbose:
            print(f"  serve: retire {spec.key()} <- lane {lane} "
                  f"(reached={result.reached}, rounds={result.rounds})",
                  flush=True)

    # -- the loop -------------------------------------------------------
    def step(self):
        """One scheduler step: advance every live trial (sync trials by
        one packed round, event trials by one macro-step) and retire
        whatever finished.  Freed lanes refill at the next
        ``admit_pending`` call."""
        self.stats.steps += 1
        occ = self.pool.occupancy()
        self.stats.occupancy_sum += occ
        if obs.enabled():
            obs.registry.sample("pool_occupancy", occ,
                                step=self.stats.steps, engine="serve")
            obs.registry.sample("queue_depth", len(self.queue),
                                step=self.stats.steps)
        if self._sync_live:
            _sync_round_step(self._sync_live, step_idx=self._sync_steps)
            self._sync_steps += 1
            for tr in [t for t in self._sync_live if t.done]:
                self._sync_live.remove(tr)
                self._retire(tr.spec, _to_result(tr, self._sync_engine))
        if self._event_live:
            ended: List = []
            self._ev.macro_step(self._event_live, ended.append)
            for tr in ended:
                self._event_live.remove(tr)
                res = TrialResult.from_flresult(
                    tr.spec, tr.eng.event_result(tr.st), tr.wall,
                    self._event_engine, local_steps=tr.local_steps)
                self._retire(tr.spec, res)

    # -- crash-safe snapshots -------------------------------------------
    def snapshot(self, path: Optional[str] = None) -> Optional[str]:
        """Serialize the full scheduler state (live trials, merged event
        queue, lane table, trial queue, counters) at the current macro-
        step boundary through the hardened two-slot checkpointer.  Call
        only between steps — mid-step state (packed cohorts) is not
        serialized.  Returns the written npz path."""
        path = path or self.snapshot_path
        if path is None:
            return None
        from repro_torch.experiments.snapshot import snapshot_scheduler
        with obs.span("snapshot", phase="snapshot", step=self.stats.steps,
                      n_live=self.pool.n_live):
            return snapshot_scheduler(self, path)

    @classmethod
    def restore(cls, path: str, *, store=None, pack: str = "batched",
                on_result: Optional[Callable[[TrialResult], None]] = None,
                watch_path: Optional[str] = None,
                verbose: bool = False,
                snapshot_every: int = 1, device=None,
                init_params: InitFn = None) -> "TrialScheduler":
        """A scheduler resumed from the newest valid snapshot at ``path``:
        live trials replay the interrupted macro-step (at most one) and
        the drain continues bit-identically to an uninterrupted serve.
        The lane capacity comes from the snapshot; every tensor is restored
        onto ``device``.  Rows re-retired during the replay are suppressed
        against ``store`` (``duplicates_suppressed`` counts them)."""
        from repro_torch.experiments.snapshot import restore_scheduler
        queue = TrialQueue(watch_path=watch_path)
        sched = cls(queue, store=store, pack=pack,
                    on_result=on_result, verbose=verbose,
                    snapshot_path=path, snapshot_every=snapshot_every,
                    device=device, init_params=init_params)
        with obs.span("restore", phase="snapshot"):
            restore_scheduler(sched, path)
        if verbose:
            print(f"  serve: restored {sched.pool.n_live} live trials at "
                  f"macro-step {sched.stats.steps} from {path}", flush=True)
        return sched

    def _maybe_snapshot(self):
        if (self.snapshot_path is not None
                and self.stats.steps % self.snapshot_every == 0):
            self.snapshot()

    def drain(self, max_results: Optional[int] = None,
              max_steps: Optional[int] = None) -> List[TrialResult]:
        """Admit + step until the queue and the pool are both empty (or
        ``max_results`` trials retired / ``max_steps`` macro-steps run
        this invocation — the kill-mid-drain hooks).  Returns every
        result retired by THIS call.  With ``snapshot_path`` set, a
        snapshot is written before every ``snapshot_every``-th step and
        once after the drain completes — a kill at any instant loses at
        most the macro-steps since the last boundary snapshot.  A
        ``max_steps`` exit IS the simulated kill, so it deliberately
        skips the final snapshot (resume must replay from the last
        boundary, exactly as after a real crash)."""
        n0 = len(self.results)
        steps0 = self.stats.steps
        killed = False
        while True:
            if max_results is not None and len(self.results) - n0 >= max_results:
                break
            if max_steps is not None and self.stats.steps - steps0 >= max_steps:
                killed = True      # simulated crash: no final snapshot
                break
            self.admit_pending()
            if not self._sync_live and not self._event_live:
                break
            self._maybe_snapshot()
            self.step()
        if not killed:
            self.snapshot()  # final boundary (no-op without snapshot_path)
        return self.results[n0:]


def serve(trials: Union[TrialQueue, Sequence[TrialSpec]], *,
          max_lanes: int = 4, store=None, pack: str = "batched",
          on_result: Optional[Callable[[TrialResult], None]] = None,
          max_results: Optional[int] = None,
          max_steps: Optional[int] = None,
          snapshot_path: Optional[str] = None,
          snapshot_every: int = 1,
          verbose: bool = False, device=None,
          init_params: InitFn = None) -> List[TrialResult]:
    """Drain ``trials`` (a ``TrialQueue`` or a plain spec list) through a
    continuous-batching ``TrialScheduler`` with ``max_lanes`` lanes.  With
    a spec list and a ``store``, already-completed keys are skipped
    (resume).  Results come back in retirement order; each is appended to
    the store as it retires.  ``snapshot_path`` arms boundary snapshots
    (see ``TrialScheduler.drain``).  Trials run on ``device`` (default
    ``cuda``), from ``init_params(spec)`` when it is given."""
    if not isinstance(trials, TrialQueue):
        completed = store.completed_keys() if store is not None else ()
        trials = TrialQueue(specs=trials, completed=completed)
    sched = TrialScheduler(trials, max_lanes=max_lanes, store=store,
                           pack=pack, on_result=on_result, verbose=verbose,
                           snapshot_path=snapshot_path,
                           snapshot_every=snapshot_every, device=device,
                           init_params=init_params)
    return sched.drain(max_results=max_results, max_steps=max_steps)
