"""Event-driven FL runtime: sync / async / buffered execution over a
heterogeneous device fleet on a virtual clock (counterpart of
``repro.runtime.engine``).

The engine separates *what* is computed (client local training,
aggregation, FedTune decisions — shared with the legacy ``FLServer`` loop)
from *when* results arrive (per-client simulated wall-clock from the
fleet's device profiles).  Three execution policies:

  sync     — rounds with a deadline: the server dispatches M clients, waits
             until an absolute deadline / completion quantile, aggregates
             whatever arrived, and cuts the stragglers.  With no deadline
             over a homogeneous fleet this IS the paper's loop.
  async    — FedAsync: every arrival is applied immediately with a
             staleness-discounted mixing rate (``fed_aggregate`` kernel);
             M acts as the in-flight concurrency.
  buffered — FedBuff: arrivals accumulate staleness-weighted *deltas* into
             a K-slot buffer flushed through the ``fed_reduce`` kernel.

All stochasticity flows from two seeded generators — the server rng
(selection + batch order, shared with the legacy loop) and a system rng
(availability/dropout) — consumed in the reference's order, so a run's
decisions, clocks and logs equal the reference's.  Sync mode trains a
round's clients one at a time (``sequential``), as one packed cohort
(``batched``, ``runtime/batched.py``), or as a cohort sharded over the
ranks of a ``torch.distributed`` group with FedAvg completed across them
(``sharded``, ``runtime/sharded.py``); ``sharded`` falls back to
``batched`` on one rank or for a non-FedAvg aggregator, printing why, as
the reference does.  Spans and metrics (``repro_torch.obs``) sit at the
reference's sites and only read clocks and counts.

The event loop is factored into plan/apply/account/finish methods over an
``EventLoopState``, each taking an optional ``queue`` (default: the
runtime's own ``EventQueue``), so the vectorized sweep runner can drive T
trials' event loops off one merged queue (``TrialQueueView``), replacing
only the training step with a packed cohort.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from repro_torch import obs
from repro_torch.core.tuner import HyperParams
from repro_torch.federated.aggregation import (FedBuffAggregator,
                                               apply_async_update)
from repro_torch.federated.compression import upload_factor
from repro_torch.federated.evaluation import eval_due
from repro_torch.federated.server import FLResult, FLServer, RoundRecord
from repro_torch.launch.mesh import world_size
from repro_torch.runtime.events import (ARRIVAL, DROPOUT, FAILURE,
                                        EventQueue, VirtualClock)
from repro_torch.runtime.profiles import Fleet, homogeneous_fleet
from repro_torch.tree import tree_map

RUNTIME_MODES = ("sync", "async", "buffered")
CLIENT_EXECS = ("sequential", "batched", "sharded")


@dataclass
class RuntimeConfig:
    """The runtime's knobs and their mode-specific settings (the
    reference's fields, validated at construction).  ``RuntimeConfig()``
    (sync, no deadline) over a homogeneous fleet reproduces
    ``FLServer.run_legacy`` round for round."""
    mode: str = "sync"                 # sync | async | buffered
    deadline: Optional[float] = None   # sync: absolute round deadline (virtual s)
    deadline_quantile: float = 1.0     # sync: cut stragglers above this
                                       # completion quantile (1.0 = wait for all)
    min_updates: int = 1               # sync: never aggregate fewer arrivals
    buffer_k: int = 8                  # buffered: updates per flush
    staleness_alpha: float = 0.5       # async/buffered: s(tau) exponent
    staleness_kind: str = "polynomial"
    async_mix: float = 0.6             # async: FedAsync mixing rate
    server_lr: float = 1.0             # buffered: flush scale
    batched: bool = False              # deprecated alias: client_exec="batched"
    client_exec: str = "sequential"    # sync client-execution backend
    system_seed: int = 0               # availability/dropout stream
    max_retries: int = 2               # retries after a hard-failed dispatch
    retry_backoff: float = 0.25        # virtual-time backoff before a retry,
                                       # as a fraction of the failed
                                       # attempt's comp+trans time

    def __post_init__(self):
        if self.mode not in RUNTIME_MODES:
            raise ValueError(
                f"unknown runtime mode {self.mode!r}; valid modes: "
                + ", ".join(RUNTIME_MODES))
        if self.client_exec not in CLIENT_EXECS:
            raise ValueError(
                f"unknown client_exec {self.client_exec!r}; valid backends: "
                + ", ".join(CLIENT_EXECS))
        if self.max_retries < 0 or self.retry_backoff < 0.0:
            raise ValueError(
                f"bad failure policy (max_retries={self.max_retries}, "
                f"retry_backoff={self.retry_backoff}); both must be >= 0")


class SyncRoundPlan(NamedTuple):
    """One sync round's participation decision, fixed BEFORE any training
    runs: who was dispatched, who made the deadline, and what the round
    costs in virtual time."""
    active: List[int]       # dispatched clients (post availability retries)
    sizes: List[int]        # their dataset sizes
    comp: List[float]       # per-client simulated compute time
    trans: List[float]      # per-client simulated transfer time
    included: List[int]     # indices into ``active`` that aggregate
    round_time: float       # virtual-clock advance for the round
    offsets: Tuple[float, ...] = ()       # per-slot dispatch delay (retries)
    failed: Tuple[int, ...] = ()          # indices into active that failed
    failed_trans: Tuple[float, ...] = ()  # their down-only transfer time

    @property
    def train_cids(self) -> List[int]:
        return [self.active[i] for i in self.included]


@dataclass
class _InFlight:
    client_id: int
    params: Any            # global params snapshot at dispatch
    version: int           # server model version at dispatch
    e: float               # local passes the client was asked to run
    n_examples: int
    comp_time: float
    trans_time: float
    attempt: int = 0       # 0 = first dispatch; bumps per failure retry


@dataclass
class EventLoopState:
    """Host-side state of ONE async/buffered trial's event loop.

    Per arrival event: ``plan_event`` (retire the in-flight record, charge
    loads; None for a dropout) -> local training from the dispatch snapshot
    -> ``apply_event`` (FedAsync mix or FedBuff add/flush) ->
    ``finish_event_round`` if an aggregation happened ->
    ``fill_event_concurrency``."""
    hp: HyperParams
    params: Any                    # current global model
    buffer: FedBuffAggregator      # buffered mode's K-slot delta buffer
    version: int = 0               # server model version (increments per agg)
    inflight: Dict[int, _InFlight] = field(default_factory=dict)
    pend_comp: List[float] = field(default_factory=list)
    pend_trans: List[float] = field(default_factory=list)
    pend_comp_load: float = 0.0
    pend_trans_load: float = 0.0
    last_agg_clock: float = 0.0
    history: List[RoundRecord] = field(default_factory=list)
    accuracy: float = 0.0
    reached: bool = False
    dispatch_log: List[tuple] = field(default_factory=list)   # (t, cid, ver)
    staleness_log: List[int] = field(default_factory=list)    # per arrival


class EventDrivenRuntime:
    """Drives one FLServer's components under a virtual clock."""

    def __init__(self, server: FLServer, fleet: Optional[Fleet] = None,
                 config: Optional[RuntimeConfig] = None):
        self.srv = server
        self.rt = config or RuntimeConfig()
        self.fleet = fleet or homogeneous_fleet(server.dataset.n_clients)
        if self.fleet.n_clients != server.dataset.n_clients:
            raise ValueError(f"fleet has {self.fleet.n_clients} clients, the "
                             f"dataset {server.dataset.n_clients}")
        self.client_exec = self._resolve_client_exec()
        self.sys_rng = np.random.default_rng(self.rt.system_seed)
        self.clock = VirtualClock()
        self.queue = EventQueue()
        self.trace_label: str = "run"     # span attribution (the trial key)
        cm = server.cost_model
        self._c1 = cm.train_flops_per_example
        self._uf = upload_factor(server.config.compression)
        self._down, self._up = cm.traffic_halves(self._uf)

    def _resolve_client_exec(self) -> str:
        """The sync-mode client-execution backend, falling back along
        sharded -> batched -> sequential where a precondition is missing
        (the reference's order and messages): ``batched=True`` is the
        legacy spelling of ``batched``; async/buffered train one arrival at
        a time; ``sharded`` needs a process group of more than one rank
        and FedAvg, whose mean it completes across the ranks."""
        mode = self.rt.client_exec
        if self.rt.batched and mode == "sequential":
            mode = "batched"    # legacy flag
        if mode == "sequential":
            return mode
        if self.rt.mode != "sync":
            print(f"runtime: {mode} execution applies to the sync mode "
                  "(async/buffered train one arrival at a time); using "
                  "the sequential client loop", flush=True)
            return "sequential"
        if mode == "sharded" and world_size() == 1:
            print("runtime: sharded execution needs a process group of "
                  "more than one rank (torch.distributed has none or one "
                  "rank; try torchrun --nproc-per-node D); falling back to "
                  "batched", flush=True)
            return "batched"
        if mode == "sharded" and self.srv.aggregator.name != "fedavg":
            print("runtime: sharded execution completes FedAvg across the "
                  f"ranks; aggregator {self.srv.aggregator.name!r} needs "
                  "per-client updates — falling back to batched",
                  flush=True)
            return "batched"
        return mode

    # ------------------------------------------------------------------
    # timing primitives
    # ------------------------------------------------------------------
    def _comp_time(self, cid: int, n_examples: int, e: float) -> float:
        return self.fleet.comp_time(cid, self._c1 * e * n_examples)

    def _trans_time(self, cid: int) -> float:
        return self.fleet.trans_time(cid, self._down, self._up)

    def _available(self, cid: int) -> bool:
        a = float(self.fleet.availability[cid])
        return a >= 1.0 or self.sys_rng.random() < a

    def _drops(self, cid: int) -> bool:
        d = float(self.fleet.dropout[cid])
        return d > 0.0 and self.sys_rng.random() < d

    def _is_active(self, cid: int, t: float) -> bool:
        """Churn membership at virtual time ``t``, checked BEFORE any
        availability draw so inactive clients consume no rng."""
        return self.fleet.is_active(cid, t)

    def _pick_replacement(self, tried: set, t: float) -> Optional[int]:
        """A fresh client for a failed slot's retry: not yet tried this
        round, active under churn, and passing an availability draw."""
        srv = self.srv
        for _ in range(5):
            if len(tried) >= srv.dataset.n_clients:
                return None
            k = min(srv.dataset.n_clients, len(tried) + 1)
            for cid in (int(c) for c in srv.selector.select(k)):  # noqa: REPRO003 -- client ids from the selector's numpy draw
                if cid in tried:
                    continue
                tried.add(cid)
                if self._is_active(cid, t) and self._available(cid):
                    return cid
        return None

    # ------------------------------------------------------------------
    def run(self, params=None) -> FLResult:
        """Run the trial to target accuracy or the round budget under the
        configured mode; ``params`` defaults to the server's seeded init."""
        params = self.srv.initial_params(params)
        if self.rt.mode == "sync":
            return self._run_sync(params)
        return self._run_event_loop(params)

    # ------------------------------------------------------------------
    # sync: deadline rounds with straggler cutoff
    # ------------------------------------------------------------------
    @obs.traced("plan_sync_round", phase="plan")
    def plan_sync_round(self, hp: HyperParams) -> SyncRoundPlan:
        """Decide one sync round's participation: selection (+ availability
        retries), per-client timing, dropout draws, failures and retries,
        and the deadline cut.  Consumes the server and system rngs in the
        reference's order."""
        srv, rt = self.srv, self.rt
        t0 = self.clock.now
        if obs.enabled() and self.fleet.churn is not None:
            obs.registry.sample("fleet_size", self.fleet.n_active(t0))
        m = min(hp.m, srv.dataset.n_clients)
        participants = [int(c) for c in srv.selector.select(m)]  # noqa: REPRO003 -- client ids from the selector's numpy draw
        active = [c for c in participants
                  if self._is_active(c, t0) and self._available(c)]
        # replace unavailable clients (bounded retries)
        tried = set(participants)
        for _ in range(5):
            if len(active) >= m or len(tried) >= srv.dataset.n_clients:
                break
            k = min(srv.dataset.n_clients, m + len(tried))
            for cid in (int(c) for c in srv.selector.select(k)):  # noqa: REPRO003 -- client ids from the selector's numpy draw
                if len(active) >= m:
                    break
                if cid in tried:
                    continue
                tried.add(cid)
                if self._is_active(cid, t0) and self._available(cid):
                    active.append(cid)

        sizes = [int(srv.dataset.client_sizes[c]) for c in active]  # noqa: REPRO003 -- client sizes are a numpy array
        comp = [self._comp_time(c, n, hp.e) for c, n in zip(active, sizes)]
        trans = [self._trans_time(c) for c in active]
        total = [c + t for c, t in zip(comp, trans)]
        survived = [not self._drops(c) for c in active]

        # hard failures + retry/reassignment (no rng draws and an unchanged
        # plan when the fleet has no failure model)
        offsets = [0.0] * len(active)
        attempts = [0] * len(active)
        failed: List[int] = []
        failed_trans: List[float] = []
        if self.fleet.has_failures():
            i = 0
            while i < len(active):
                cid = active[i]
                if self.fleet.fails(cid, t0 + offsets[i], attempts[i]):
                    survived[i] = False
                    failed.append(i)
                    failed_trans.append(
                        self.fleet.trans_time(cid, self._down, 0.0))
                    detect = offsets[i] + comp[i] + trans[i]
                    if obs.enabled():
                        obs.registry.inc("client_failures")
                        obs.record("failure", phase="failure",
                                   trial=self.trace_label,
                                   virtual=(t0 + offsets[i], t0 + detect),
                                   cid=int(cid), attempt=attempts[i])  # noqa: REPRO003 -- a client id from the selector's numpy draw
                    if attempts[i] < rt.max_retries:
                        backoff = rt.retry_backoff * (comp[i] + trans[i])
                        rep = self._pick_replacement(tried, t0)
                        if rep is not None:
                            n = int(srv.dataset.client_sizes[rep])  # noqa: REPRO003 -- client sizes are a numpy array
                            active.append(rep)
                            sizes.append(n)
                            comp.append(self._comp_time(rep, n, hp.e))
                            trans.append(self._trans_time(rep))
                            offsets.append(detect + backoff)
                            attempts.append(attempts[i] + 1)
                            survived.append(not self._drops(rep))
                            if obs.enabled():
                                obs.registry.inc("retries_scheduled")
                                obs.record(
                                    "retry", phase="failure",
                                    trial=self.trace_label,
                                    virtual=(t0 + detect,
                                             t0 + detect + backoff),
                                    cid=int(rep),  # noqa: REPRO003 -- a client id from the selector's numpy draw
                                    attempt=attempts[i] + 1)
                i += 1
            total = [o + c + t
                     for o, c, t in zip(offsets, comp, trans)]

        # deadline: absolute budget or completion quantile over the cohort
        deadline = np.inf
        if rt.deadline is not None:
            deadline = rt.deadline
        elif rt.deadline_quantile < 1.0 and total:
            deadline = float(np.quantile(total, rt.deadline_quantile))
        order = np.argsort(np.asarray(total, np.float64),
                           kind="stable") if total else []
        chosen = set()             # indices into active, by arrival order
        for i in order:
            i = int(i)  # noqa: REPRO003 -- an index from np.argsort
            if survived[i] and (total[i] <= deadline
                                or len(chosen) < rt.min_updates):
                chosen.add(i)
        # train + aggregate in dispatch order
        included = [i for i in range(len(active)) if i in chosen]
        cut_any = len(included) < sum(survived)
        if included:
            waited = max(total[i] for i in included)
            round_time = max(deadline, waited) if (
                cut_any and np.isfinite(deadline)) else waited
        else:
            round_time = deadline if np.isfinite(deadline) else (
                max(total) if total else 0.0)
        if obs.enabled():
            obs.registry.inc("sync_dispatched", len(active))
            obs.registry.inc("sync_dropouts",
                             len(active) - sum(survived) - len(failed))
            obs.registry.inc("sync_stragglers_cut",
                             sum(survived) - len(included))
        return SyncRoundPlan(active=active, sizes=sizes, comp=comp,
                             trans=trans, included=included,
                             round_time=round_time,
                             offsets=tuple(offsets), failed=tuple(failed),
                             failed_trans=tuple(failed_trans))

    @obs.traced("account_sync_round", phase="account")
    def account_sync_round(self, plan: SyncRoundPlan, hp: HyperParams):
        """Charge one planned sync round to the cost model: critical-path
        times over the included arrivals (and failed attempts), exact
        work/traffic sums over the dispatched cohort."""
        comp_time = max((plan.comp[i] for i in plan.included), default=0.0)
        trans_time = max((plan.trans[i] for i in plan.included), default=0.0)
        if plan.failed:
            comp_time = max([comp_time]
                            + [plan.comp[i] for i in plan.failed])
            trans_time = max([trans_time] + list(plan.failed_trans))
        return self.srv.cost_model.add_timed_round(
            comp_time=comp_time,
            trans_time=trans_time,
            comp_load=self._c1 * hp.e * float(sum(plan.sizes)),
            trans_load=(self._down * len(plan.active)
                        + self._up * len(plan.included)),
        )

    def _run_sync(self, params) -> FLResult:
        srv, cfg = self.srv, self.srv.config
        hp = HyperParams(m=cfg.m, e=cfg.e)
        history: List[RoundRecord] = []
        accuracy = 0.0
        reached = False

        for r in range(cfg.max_rounds):
            t0 = time.perf_counter()  # noqa: REPRO004 -- measures the RoundRecord.wall info field only; results use self.clock virtual time
            v0 = self.clock.now
            plan = self.plan_sync_round(hp)
            self.clock.advance_to(self.clock.now + plan.round_time)
            included, active = plan.included, plan.active

            if included:
                if self.client_exec == "sharded":
                    # the FedAvg mean is already complete on every rank:
                    # no per-client updates exist
                    params = self._sharded_round(params, plan.train_cids,
                                                 hp.e)
                else:
                    if self.client_exec == "batched":
                        updates = self._batched_cohort(
                            params, plan.train_cids, hp.e)
                    else:
                        updates = [srv._client_update(params, cid, hp.e)[0]
                                   for cid in plan.train_cids]
                    params = srv.aggregator(params, updates)
            round_cost = self.account_sync_round(plan, hp)

            if eval_due(r, cfg.eval_every, cfg.max_rounds):
                accuracy = srv._evaluate(params)
            t1 = time.perf_counter()  # noqa: REPRO004 -- RoundRecord.wall is informational; parity ignores it
            wall = t1 - t0
            if obs.enabled():
                obs.record("round", phase="round", trial=self.trace_label,
                           round_idx=r, wall=(t0, t1),
                           virtual=(v0, self.clock.now),
                           n_included=len(included), n_active=len(active))
                obs.counter("t_sim", self.clock.now)
            history.append(RoundRecord(r, hp.m, hp.e, accuracy, round_cost,
                                       wall, sim_time=self.clock.now,
                                       n_updates=len(included)))
            if cfg.log_every and (r + 1) % cfg.log_every == 0:
                print(f"  round {r+1:4d}  acc={accuracy:.4f}  M={hp.m} "
                      f"E={hp.e:g}  arrived={len(included)}/{len(active)} "
                      f"t_sim={self.clock.now:.3g}", flush=True)
            if accuracy >= cfg.target_accuracy:
                reached = True
                break
            hp = srv.tuner.on_round(r, accuracy, round_cost,
                                    srv.cost_model.total, hp)
            hp = hp.clamped(srv.dataset.n_clients, 100.0)

        return FLResult(
            reached_target=reached, rounds=len(history),
            final_accuracy=accuracy,
            total_cost=srv.cost_model.total.copy(), history=history,
            final_m=hp.m, final_e=hp.e, params=params,
            sim_time=self.clock.now)

    def _batched_cohort(self, params, active: List[int], e: float):
        """One round's clients as a packed cohort (``batched_local_train``,
        the same rng contract as the sequential loop)."""
        from repro_torch.runtime.batched import batched_local_train
        srv = self.srv
        data = [srv.dataset.client_data(c) for c in active]
        updates = batched_local_train(
            srv.model, params, data, passes=e,
            batch_size=srv.config.batch_size, optimizer=srv.optimizer,
            rng=srv.rng, prox_mu=srv.config.prox_mu, client_ids=active,
            compression=srv.config.compression)
        for upd, (_, y) in zip(updates, data):
            srv.selector.update(upd.client_id, upd.last_loss, len(y))
        return updates

    def _sharded_round(self, params, active: List[int], e: float):
        """One round's clients sharded over the ranks
        (``sharded_fedavg_train``): the FedAvg aggregate, with the
        selector fed from every client's loss and size."""
        from repro_torch.runtime.sharded import sharded_fedavg_train
        srv = self.srv
        data = [srv.dataset.client_data(c) for c in active]
        res = sharded_fedavg_train(
            srv.model, params, data, passes=e,
            batch_size=srv.config.batch_size, optimizer=srv.optimizer,
            rng=srv.rng, prox_mu=srv.config.prox_mu, client_ids=active,
            compression=srv.config.compression)
        for cid, loss, n in zip(active, res.last_losses, res.n_examples):
            srv.selector.update(int(cid), float(loss), n)  # noqa: REPRO003 -- ids and losses are numpy arrays
        return res.params

    # ------------------------------------------------------------------
    # async / buffered: an event loop over the virtual clock
    # ------------------------------------------------------------------
    def init_event_state(self, params, queue=None) -> EventLoopState:
        """Fresh event-loop state with the initial concurrency dispatched
        at t=0 into ``queue``."""
        cfg, rt = self.srv.config, self.rt
        st = EventLoopState(
            hp=HyperParams(m=cfg.m, e=cfg.e), params=params,
            buffer=FedBuffAggregator(
                buffer_k=rt.buffer_k, server_lr=rt.server_lr,
                staleness_alpha=rt.staleness_alpha,
                staleness_kind=rt.staleness_kind))
        self.fill_event_concurrency(st, 0.0, queue)
        return st

    def dispatch_event(self, st: EventLoopState, cid: int, now: float,
                       queue=None, attempt: int = 0):
        """Send the current global model to one client: snapshot it into an
        ``_InFlight`` record, draw the client's dropout (system rng; kept
        even when the failure model overrides the outcome, so the stream
        stays aligned), and schedule its arrival/dropout/failure event."""
        srv = self.srv
        n = int(srv.dataset.client_sizes[cid])
        comp = self._comp_time(cid, n, st.hp.e)
        trans = self._trans_time(cid)
        st.inflight[cid] = _InFlight(cid, st.params, st.version, st.hp.e,
                                     n, comp, trans, attempt=attempt)
        st.dispatch_log.append((float(now), int(cid), st.version))
        kind = DROPOUT if self._drops(cid) else ARRIVAL
        if self.fleet.has_failures() and self.fleet.fails(cid, now, attempt):
            kind = FAILURE
        if obs.enabled():
            obs.registry.inc("event_dispatched")
        queue = self.queue if queue is None else queue
        queue.push(now + comp + trans, kind, client_id=cid)

    def handle_failure(self, st: EventLoopState, ev, queue=None):
        """A FAILURE event: charge the wasted work into the pending window
        and, within the retry budget, re-dispatch the same client after a
        backoff proportional to the failed attempt."""
        fl = st.inflight.pop(ev.client_id)
        down_trans = self.fleet.trans_time(fl.client_id, self._down, 0.0)
        st.pend_comp_load += self._c1 * fl.e * fl.n_examples
        st.pend_trans_load += self._down
        st.pend_comp.append(fl.comp_time)
        st.pend_trans.append(down_trans)
        if obs.enabled():
            obs.registry.inc("client_failures")
            obs.record("failure", phase="failure", trial=self.trace_label,
                       virtual=(ev.time - fl.comp_time - fl.trans_time,
                                ev.time),
                       cid=fl.client_id, attempt=fl.attempt)
        if fl.attempt < self.rt.max_retries:
            backoff = self.rt.retry_backoff * (fl.comp_time + fl.trans_time)
            if obs.enabled():
                obs.registry.inc("retries_scheduled")
                obs.record("retry", phase="failure", trial=self.trace_label,
                           virtual=(ev.time, ev.time + backoff),
                           cid=fl.client_id, attempt=fl.attempt + 1)
            self.dispatch_event(st, fl.client_id, ev.time + backoff,
                                queue, attempt=fl.attempt + 1)

    def fill_event_concurrency(self, st: EventLoopState, now: float,
                               queue=None):
        """Top up in-flight clients to M."""
        queue = self.queue if queue is None else queue
        srv = self.srv
        target = min(st.hp.m, srv.dataset.n_clients)
        if obs.enabled() and self.fleet.churn is not None:
            obs.registry.sample("fleet_size", self.fleet.n_active(now))
        for _ in range(5):               # availability retry passes
            need = target - len(st.inflight)
            if need <= 0:
                return
            k = min(srv.dataset.n_clients, need + len(st.inflight))
            candidates = [int(c) for c in srv.selector.select(k)  # noqa: REPRO003 -- client ids from the selector's numpy draw
                          if int(c) not in st.inflight]  # noqa: REPRO003 -- client ids from the selector's numpy draw
            for cid in candidates:
                if len(st.inflight) >= target:
                    return
                if not self._is_active(cid, now):
                    continue
                if self._available(cid):
                    self.dispatch_event(st, cid, now, queue)
        # deadlock guard: nothing in flight and nothing queued
        if not st.inflight and not queue:
            cohort = [int(c) for c in srv.selector.select(1)]  # noqa: REPRO003 -- client ids from the selector's numpy draw
            if cohort:
                self.dispatch_event(st, cohort[0], now, queue)

    @obs.traced("plan_event", phase="plan")
    def plan_event(self, st: EventLoopState, ev) -> Optional[_InFlight]:
        """Retire one popped event's in-flight record and charge its loads.
        Returns the record whose client must now train, or None for a
        dropout."""
        fl = st.inflight.pop(ev.client_id)
        if obs.enabled():
            obs.record("inflight", phase="inflight", trial=self.trace_label,
                       virtual=(ev.time - fl.comp_time - fl.trans_time,
                                ev.time),
                       cid=fl.client_id,
                       kind="dropout" if ev.kind == DROPOUT else "arrival")
            if ev.kind == DROPOUT:
                obs.registry.inc("event_dropouts")
        st.pend_comp_load += self._c1 * fl.e * fl.n_examples
        st.pend_trans_load += self._down
        if ev.kind == DROPOUT:
            return None
        st.pend_trans_load += self._up
        st.pend_comp.append(fl.comp_time)
        st.pend_trans.append(fl.trans_time)
        return fl

    @obs.traced("apply_event", phase="apply")
    def apply_event(self, st: EventLoopState, fl: _InFlight,
                    client_params) -> Tuple[bool, int]:
        """Fold one trained arrival into the global model: FedAsync mixing
        (async) or a FedBuff delta add, flushing when K deltas
        accumulated.  Returns (aggregated, staleness)."""
        rt = self.rt
        staleness = st.version - fl.version
        st.staleness_log.append(int(staleness))
        if obs.enabled():
            obs.registry.observe("staleness", staleness)
        if rt.mode == "async":
            st.params = apply_async_update(
                st.params, client_params, mix=rt.async_mix,
                staleness=staleness, alpha=rt.staleness_alpha,
                kind=rt.staleness_kind)
            return True, staleness
        delta = tree_map(lambda a, b: a - b, client_params, fl.params)
        st.buffer.add(delta, staleness)
        if st.buffer.full:
            st.params = st.buffer.flush(st.params)
            return True, staleness
        return False, staleness

    @obs.traced("account_event_round", phase="account")
    def account_event_round(self, st: EventLoopState):
        """Charge one aggregation window to the cost model and reset the
        pending accumulators."""
        dt = self.clock.now - st.last_agg_clock
        csum, tsum = sum(st.pend_comp), sum(st.pend_trans)
        frac = csum / (csum + tsum) if (csum + tsum) > 0 else 0.0
        round_cost = self.srv.cost_model.add_timed_round(
            comp_time=dt * frac, trans_time=dt * (1.0 - frac),
            comp_load=st.pend_comp_load, trans_load=st.pend_trans_load)
        st.pend_comp, st.pend_trans = [], []
        st.pend_comp_load = st.pend_trans_load = 0.0
        st.last_agg_clock = self.clock.now
        return round_cost

    @obs.traced("finish_event_round", phase="finish")
    def finish_event_round(self, st: EventLoopState, staleness: int,
                           wall: float, accuracy: Optional[float] = None):
        """Complete one aggregation: bump the model version, account the
        window, evaluate on schedule, record history, and step the FedTune
        controller — or set ``st.reached`` if the target was hit.
        ``accuracy`` is the sweep runner's hook: its lane of one stacked
        evaluation of every aggregating trial, used in place of this
        trial's own evaluation."""
        srv, cfg, rt = self.srv, self.srv.config, self.rt
        st.version += 1
        r = len(st.history)
        if obs.enabled():
            obs.record("agg_window", phase="round", trial=self.trace_label,
                       round_idx=r,
                       virtual=(st.last_agg_clock, self.clock.now),
                       staleness=int(staleness))
            obs.counter("t_sim", self.clock.now)
        round_cost = self.account_event_round(st)
        if accuracy is not None:
            st.accuracy = accuracy
        elif eval_due(r, cfg.eval_every, cfg.max_rounds):
            st.accuracy = srv._evaluate(st.params)
        st.history.append(RoundRecord(
            r, st.hp.m, st.hp.e, st.accuracy, round_cost, wall,
            sim_time=self.clock.now,
            n_updates=(1 if rt.mode == "async" else rt.buffer_k)))
        if cfg.log_every and (r + 1) % cfg.log_every == 0:
            print(f"  agg {r+1:4d}  acc={st.accuracy:.4f}  M={st.hp.m} "
                  f"E={st.hp.e:g}  stale={staleness} "
                  f"t_sim={self.clock.now:.3g}", flush=True)
        if st.accuracy >= cfg.target_accuracy:
            st.reached = True
            return
        st.hp = srv.tuner.on_round(r, st.accuracy, round_cost,
                                   srv.cost_model.total, st.hp)
        st.hp = st.hp.clamped(srv.dataset.n_clients, 100.0)

    @obs.traced("account_event_tail", phase="account")
    def account_event_tail(self, st: EventLoopState):
        """Account the loads of arrivals after the last aggregation."""
        if st.pend_comp_load > 0.0 or st.pend_trans_load > 0.0:
            self.account_event_round(st)

    def event_result(self, st: EventLoopState) -> FLResult:
        return FLResult(
            reached_target=st.reached, rounds=len(st.history),
            final_accuracy=st.accuracy,
            total_cost=self.srv.cost_model.total.copy(), history=st.history,
            final_m=st.hp.m, final_e=st.hp.e, params=st.params,
            sim_time=self.clock.now, dispatch_log=st.dispatch_log,
            staleness_log=st.staleness_log)

    def _run_event_loop(self, params) -> FLResult:
        srv, cfg = self.srv, self.srv.config
        st = self.init_event_state(params)
        last_wall = time.perf_counter()  # noqa: REPRO004 -- per-round wall info field; event ordering uses the virtual clock

        while self.queue and len(st.history) < cfg.max_rounds \
                and not st.reached:
            ev = self.queue.pop()
            self.clock.advance_to(ev.time)
            if ev.kind == FAILURE:           # hard failure: retry, refill
                self.handle_failure(st, ev)
                self.fill_event_concurrency(st, self.clock.now)
                continue
            fl = self.plan_event(st, ev)
            if fl is None:                   # dropout: refill and move on
                self.fill_event_concurrency(st, self.clock.now)
                continue
            upd, _n = srv._client_update(fl.params, fl.client_id, fl.e)
            aggregated, staleness = self.apply_event(st, fl, upd.params)
            if aggregated:
                now_wall = time.perf_counter()  # noqa: REPRO004 -- per-round wall info field; event ordering uses the virtual clock
                self.finish_event_round(st, staleness, now_wall - last_wall)
                last_wall = now_wall
                if st.reached:
                    break
            self.fill_event_concurrency(st, self.clock.now)

        self.account_event_tail(st)
        return self.event_result(st)
