"""Scheduler snapshot/restore: the crash-safe half of fault-tolerant
serving (counterpart of ``repro.experiments.snapshot``).

``snapshot_scheduler`` serializes a ``TrialScheduler``'s COMPLETE state at
a macro-step boundary — every live trial's params/rngs/clock/histories,
in-flight dispatch snapshots, FedBuff delta buffers, the merged event
queue's pending heap, the lane page table, the trial queue, and the
scheduler's own counters — through the two-slot checkpointer
(``repro_torch.checkpoint``).  ``restore_scheduler`` rebuilds a scheduler that
replays the interrupted macro-step and then continues bit-identically to
an uninterrupted drain.

Serialization split: everything array-shaped (params trees, in-flight
dispatch snapshots, buffered deltas) goes into the npz half keyed by a
``t{i}/...`` leaf prefix; everything host-side (rng bit-generator states,
virtual clocks, cost totals, FedTune controller state, histories, queue
and pool inventories, and the port's per-trial ``local_steps``) is JSON in
the metadata half.  Restore rebuilds each trial via ``build_server`` (so
model/optimizer/dataset come from the shared caches) on the scheduler's
device and then OVERWRITES all stochastic state — it deliberately never
calls ``init_event_state``, whose dispatch draws would desync the restored
rng streams.  The params template is the port's seeded ``model.init``,
used for shapes and dtypes only.

The at-most-one-step contract (pinned in tests/test_torch_serve.py): snapshots
are taken at macro-step boundaries, so a kill loses only the partial step
after the last boundary; on restore that step replays.  A trial that
retired DURING the replayed step before the kill already has its row in
the JSONL store — the scheduler's ``_retire`` suppresses the duplicate
append (``store.is_completed``), so the store ends bit-identical to the
uninterrupted serve, rows in the same order.
"""

from __future__ import annotations

import heapq
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.checkpoint import load_snapshot, restore_tree, save_snapshot
from repro_torch.checkpoint.checkpointer import keyed_leaves
from repro_torch.core.costs import SystemCost
from repro_torch.core.fedtune import FedTune, _Window
from repro_torch.core.tuner import HyperParams
from repro_torch.federated.server import RoundRecord
from repro_torch.runtime.engine import _InFlight
from repro_torch.runtime.events import TaggedEvent

SNAPSHOT_VERSION = 1


# ---------------------------------------------------------------------------
# small host-state codecs
# ---------------------------------------------------------------------------

def _rng_state(rng: np.random.Generator) -> dict:
    return rng.bit_generator.state          # JSON-serializable dict


def _set_rng_state(rng: np.random.Generator, state: dict) -> None:
    rng.bit_generator.state = state


def _record_to_dict(r: RoundRecord) -> dict:
    return {"round_idx": r.round_idx, "m": r.m, "e": r.e,
            "accuracy": r.accuracy, "cost": list(r.cost.as_tuple()),
            "wall_time": r.wall_time, "sim_time": r.sim_time,
            "n_updates": r.n_updates}


def _record_from_dict(d: dict) -> RoundRecord:
    return RoundRecord(round_idx=int(d["round_idx"]), m=int(d["m"]),
                       e=float(d["e"]), accuracy=float(d["accuracy"]),
                       cost=SystemCost(*d["cost"]),
                       wall_time=float(d["wall_time"]),
                       sim_time=float(d["sim_time"]),
                       n_updates=int(d["n_updates"]))


def _tuner_state(tuner) -> Optional[dict]:
    if not isinstance(tuner, FedTune):
        return None                          # FixedTuner is stateless
    return {
        "current": [tuner.current.m, tuner.current.e],
        "prev_hp": ([tuner.prev_hp.m, tuner.prev_hp.e]
                    if tuner.prev_hp is not None else None),
        "last_acc": tuner._last_acc,
        "acc_at_last_decision": tuner._acc_at_last_decision,
        "window_cost": list(tuner._window_cost.as_tuple()),
        "prv": list(tuner._prv.values) if tuner._prv is not None else None,
        "prvprv": (list(tuner._prvprv.values)
                   if tuner._prvprv is not None else None),
        "eta": list(tuner.eta), "zeta": list(tuner.zeta),
        "decisions": tuner.decisions,
        "trace": tuner.trace,
    }


def _set_tuner_state(tuner, d: Optional[dict]) -> None:
    if d is None or not isinstance(tuner, FedTune):
        return
    tuner.current = HyperParams(int(d["current"][0]), float(d["current"][1]))
    tuner.prev_hp = (HyperParams(int(d["prev_hp"][0]), float(d["prev_hp"][1]))
                     if d["prev_hp"] is not None else None)
    tuner._last_acc = float(d["last_acc"])
    tuner._acc_at_last_decision = float(d["acc_at_last_decision"])
    tuner._window_cost = SystemCost(*d["window_cost"])
    tuner._prv = (_Window(values=list(d["prv"]))
                  if d["prv"] is not None else None)
    tuner._prvprv = (_Window(values=list(d["prvprv"]))
                     if d["prvprv"] is not None else None)
    tuner.eta = list(d["eta"])
    tuner.zeta = list(d["zeta"])
    tuner.decisions = int(d["decisions"])
    # JSON round-trips the decision windows' tuples as lists
    tuner.trace = [dict(t, window=tuple(t["window"])) if "window" in t
                   else dict(t) for t in d["trace"]]


def _engine_state(tr) -> dict:
    """Host state shared by sync and event live trials: the runtime's
    clocks/rngs, the server's cost totals, and any stateful selector."""
    d = {
        "clock": tr.eng.clock.now,
        "srv_rng": _rng_state(tr.srv.rng),
        "sys_rng": _rng_state(tr.eng.sys_rng),
        "cost_total": list(tr.srv.cost_model.total.as_tuple()),
        "cost_rounds": tr.srv.cost_model.rounds,
        "tuner": _tuner_state(tr.srv.tuner),
    }
    if hasattr(tr.srv.selector, "utility"):
        d["sel_utility"] = [float(u) for u in tr.srv.selector.utility]  # noqa: REPRO003 -- a snapshot's JSON field, a host value
    return d


def _set_engine_state(tr, d: dict) -> None:
    tr.eng.clock._now = float(d["clock"])
    _set_rng_state(tr.srv.rng, d["srv_rng"])      # selector shares this rng
    _set_rng_state(tr.eng.sys_rng, d["sys_rng"])
    tr.srv.cost_model.total = SystemCost(*d["cost_total"])
    tr.srv.cost_model.rounds = int(d["cost_rounds"])
    _set_tuner_state(tr.srv.tuner, d.get("tuner"))
    if "sel_utility" in d:
        tr.srv.selector.utility = np.array(d["sel_utility"])


def _collect_leaves(leaves: Dict[str, Any], prefix: str, tree: Any) -> None:
    for k, x in keyed_leaves(tree):
        leaves.setdefault(prefix + k, x)


# ---------------------------------------------------------------------------
# snapshot
# ---------------------------------------------------------------------------

def snapshot_scheduler(sched, path: str) -> str:
    """Serialize the scheduler at a macro-step boundary; returns the
    written npz path."""
    leaves: Dict[str, Any] = {}
    trials: List[dict] = []

    for tr in sched._sync_live:
        i = len(trials)
        _collect_leaves(leaves, f"t{i}/params/", tr.params)
        trials.append({
            "kind": "sync", "spec": tr.spec.to_dict(),
            "hp": [tr.hp.m, tr.hp.e],
            "round_idx": tr.round_idx, "accuracy": tr.accuracy,
            "reached": tr.reached, "done": tr.done, "wall": tr.wall,
            "local_steps": tr.local_steps,
            "history": [_record_to_dict(r) for r in tr.history],
            "engine": _engine_state(tr),
        })

    for tr in sched._event_live:
        i = len(trials)
        st = tr.st
        _collect_leaves(leaves, f"t{i}/params/", st.params)
        inflight = []
        for j, (cid, fl) in enumerate(st.inflight.items()):
            _collect_leaves(leaves, f"t{i}/if{j}/", fl.params)
            inflight.append({"cid": int(cid), "version": fl.version,  # noqa: REPRO003 -- a snapshot's JSON field, a host value
                             "e": fl.e, "n_examples": fl.n_examples,
                             "comp_time": fl.comp_time,
                             "trans_time": fl.trans_time,
                             "attempt": fl.attempt})
        for j, delta in enumerate(st.buffer._deltas):
            _collect_leaves(leaves, f"t{i}/d{j}/", delta)
        trials.append({
            "kind": "event", "spec": tr.spec.to_dict(),
            "trial_ord": tr.view.trial_ord,
            "hp": [st.hp.m, st.hp.e],
            "version": st.version, "accuracy": st.accuracy,
            "reached": st.reached, "done": tr.done, "wall": tr.wall,
            "local_steps": tr.local_steps,
            "pend_comp": list(st.pend_comp),
            "pend_trans": list(st.pend_trans),
            "pend_comp_load": st.pend_comp_load,
            "pend_trans_load": st.pend_trans_load,
            "last_agg_clock": st.last_agg_clock,
            "history": [_record_to_dict(r) for r in st.history],
            "dispatch_log": [list(t) for t in st.dispatch_log],
            "staleness_log": list(st.staleness_log),
            "inflight": inflight,
            "buffer_weights": [float(w) for w in st.buffer._weights],  # noqa: REPRO003 -- a snapshot's JSON field, a host value
            "engine": _engine_state(tr),
        })

    ev = sched._ev
    meta = {
        "version": SNAPSHOT_VERSION,
        "trials": trials,
        "pool": {"capacity": sched.pool.capacity,
                 "page": {str(lane): key
                          for lane, key in sched.pool._page.items()}},
        "queue": {
            "pending": [s.to_dict() for s in sched.queue._pending],
            "seen": sorted(sched.queue._seen),
            "done": sorted(sched.queue._done),
            "watch_pos": sched.queue._watch_pos,
            "n_submitted": sched.queue.n_submitted,
            "n_skipped": sched.queue.n_skipped,
        },
        "merged": {
            "seq": {str(k): v for k, v in ev.merged._seq.items()},
            "events": [[e.time, e.trial_ord, e.seq, e.kind, e.client_id]
                       for e in ev.merged._heap],
        },
        "ev": {"n_steps": ev.n_steps, "next_ord": ev.next_ord},
        "stats": {"admitted": sched.stats.admitted,
                  "retired": sched.stats.retired,
                  "steps": sched.stats.steps,
                  "occupancy_sum": sched.stats.occupancy_sum,
                  "admission_log": [list(t)
                                    for t in sched.stats.admission_log]},
        "sync_steps": sched._sync_steps,
    }
    return save_snapshot(path, leaves, step=sched.stats.steps, metadata=meta)


# ---------------------------------------------------------------------------
# restore
# ---------------------------------------------------------------------------

def restore_scheduler(sched, path: str) -> None:
    """Rebuild ``sched``'s live state from the newest valid snapshot at
    ``path``.  ``sched`` must be freshly constructed (empty pool, no live
    trials); its queue/store/pack/device wiring is kept, everything else
    is overwritten, and every tensor lands on ``sched.device``."""
    from repro_torch.experiments.grid import spec_from_dict
    from repro_torch.experiments.runner import (_EventTrial, _make_live,
                                                build_server)
    from repro_torch.federated.aggregation import FedBuffAggregator
    from repro_torch.runtime.engine import (EventDrivenRuntime,
                                            EventLoopState, RuntimeConfig)
    from repro_torch.runtime.events import TrialQueueView

    arrays, meta = load_snapshot(path)
    if meta.get("version") != SNAPSHOT_VERSION:
        raise ValueError(f"unsupported snapshot version "
                         f"{meta.get('version')!r} at {path}")

    # queue: internal inventory, NOT submit() (no re-validation/counting)
    q = sched.queue
    q._pending.clear()
    q._pending.extend(spec_from_dict(d) for d in meta["queue"]["pending"])
    q._seen = set(meta["queue"]["seen"])
    q._done |= set(meta["queue"]["done"])
    q._watch_pos = int(meta["queue"]["watch_pos"])
    q.n_submitted = int(meta["queue"]["n_submitted"])
    q.n_skipped = int(meta["queue"]["n_skipped"])

    # lane page table: capacity comes from the snapshot (the lane<->trial
    # mapping is only meaningful at its own capacity), held lanes are
    # re-pinned and the free list derived (min-heap by index)
    from repro_torch.experiments.scheduler import LanePool
    sched.pool = pool = LanePool(int(meta["pool"]["capacity"]))
    pool._page = {int(l): k for l, k in meta["pool"]["page"].items()}
    pool._lane = {k: l for l, k in pool._page.items()}
    pool._free = [l for l in range(pool.capacity) if l not in pool._page]

    ev = sched._ev
    ev.n_steps = int(meta["ev"]["n_steps"])
    ev.next_ord = int(meta["ev"]["next_ord"])
    ev.merged._seq = {int(k): int(v)  # noqa: REPRO003 -- a snapshot's JSON field, a host value
                      for k, v in meta["merged"]["seq"].items()}

    for i, td in enumerate(meta["trials"]):
        spec = spec_from_dict(td["spec"])
        eng_d = td["engine"]
        if td["kind"] == "sync":
            tr = _make_live(spec, sched.device, sched.init_params)
            tr.hp = HyperParams(int(td["hp"][0]), float(td["hp"][1]))  # noqa: REPRO003 -- a snapshot's JSON field, a host value
            tr.params = restore_tree(arrays, tr.params,
                                     prefix=f"t{i}/params/")
            tr.round_idx = int(td["round_idx"])  # noqa: REPRO003 -- a snapshot's JSON field, a host value
            tr.accuracy = float(td["accuracy"])  # noqa: REPRO003 -- a snapshot's JSON field, a host value
            tr.reached = bool(td["reached"])  # noqa: REPRO003 -- a snapshot's JSON field, a host value
            tr.done = bool(td["done"])  # noqa: REPRO003 -- a snapshot's JSON field, a host value
            tr.wall = float(td["wall"])  # noqa: REPRO003 -- a snapshot's JSON field, a host value
            tr.local_steps = int(td["local_steps"])  # noqa: REPRO003 -- a snapshot's JSON field, a host value
            tr.history = [_record_from_dict(r) for r in td["history"]]
            _set_engine_state(tr, eng_d)
            sched._sync_live.append(tr)
            continue

        # event trial: manual construction — init_event_state would draw
        # from the rngs we are about to overwrite
        srv = build_server(spec, sched.device)
        eng = EventDrivenRuntime(srv, fleet=srv.fleet,
                                 config=srv.runtime_config
                                 or RuntimeConfig())
        eng.trace_label = spec.key()
        trial_ord = int(td["trial_ord"])  # noqa: REPRO003 -- a snapshot's JSON field, a host value
        view = TrialQueueView(ev.merged, trial_ord)
        tr = _EventTrial(spec=spec, srv=srv, eng=eng, view=view)
        template = srv.model.init(srv.config.seed, sched.device)
        rt = eng.rt
        st = EventLoopState(
            hp=HyperParams(int(td["hp"][0]), float(td["hp"][1])),  # noqa: REPRO003 -- a snapshot's JSON field, a host value
            params=restore_tree(arrays, template, prefix=f"t{i}/params/"),
            buffer=FedBuffAggregator(
                buffer_k=rt.buffer_k, server_lr=rt.server_lr,
                staleness_alpha=rt.staleness_alpha,
                staleness_kind=rt.staleness_kind))
        st.version = int(td["version"])  # noqa: REPRO003 -- a snapshot's JSON field, a host value
        st.accuracy = float(td["accuracy"])  # noqa: REPRO003 -- a snapshot's JSON field, a host value
        st.reached = bool(td["reached"])  # noqa: REPRO003 -- a snapshot's JSON field, a host value
        st.pend_comp = [float(v) for v in td["pend_comp"]]  # noqa: REPRO003 -- a snapshot's JSON field, a host value
        st.pend_trans = [float(v) for v in td["pend_trans"]]  # noqa: REPRO003 -- a snapshot's JSON field, a host value
        st.pend_comp_load = float(td["pend_comp_load"])  # noqa: REPRO003 -- a snapshot's JSON field, a host value
        st.pend_trans_load = float(td["pend_trans_load"])  # noqa: REPRO003 -- a snapshot's JSON field, a host value
        st.last_agg_clock = float(td["last_agg_clock"])  # noqa: REPRO003 -- a snapshot's JSON field, a host value
        st.history = [_record_from_dict(r) for r in td["history"]]
        st.dispatch_log = [tuple(t) for t in td["dispatch_log"]]
        st.staleness_log = [int(s) for s in td["staleness_log"]]  # noqa: REPRO003 -- a snapshot's JSON field, a host value
        for j, fd in enumerate(td["inflight"]):
            st.inflight[int(fd["cid"])] = _InFlight(  # noqa: REPRO003 -- a snapshot's JSON field, a host value
                client_id=int(fd["cid"]),  # noqa: REPRO003 -- a snapshot's JSON field, a host value
                params=restore_tree(arrays, template, prefix=f"t{i}/if{j}/"),
                version=int(fd["version"]), e=float(fd["e"]),  # noqa: REPRO003 -- a snapshot's JSON field, a host value
                n_examples=int(fd["n_examples"]),  # noqa: REPRO003 -- a snapshot's JSON field, a host value
                comp_time=float(fd["comp_time"]),  # noqa: REPRO003 -- a snapshot's JSON field, a host value
                trans_time=float(fd["trans_time"]),  # noqa: REPRO003 -- a snapshot's JSON field, a host value
                attempt=int(fd["attempt"]))  # noqa: REPRO003 -- a snapshot's JSON field, a host value
        for j, w in enumerate(td["buffer_weights"]):
            st.buffer._deltas.append(
                restore_tree(arrays, template, prefix=f"t{i}/d{j}/"))
            st.buffer._weights.append(float(w))  # noqa: REPRO003 -- a snapshot's JSON field, a host value
        tr.st = st
        tr.done = bool(td["done"])  # noqa: REPRO003 -- a snapshot's JSON field, a host value
        tr.wall = float(td["wall"])  # noqa: REPRO003 -- a snapshot's JSON field, a host value
        tr.local_steps = int(td["local_steps"])  # noqa: REPRO003 -- a snapshot's JSON field, a host value
        _set_engine_state(tr, eng_d)
        ev.by_ord[trial_ord] = tr
        sched._event_live.append(tr)

    # the merged heap: original (time, trial_ord, seq) keys, re-heapified
    heap = [TaggedEvent(time=float(t), trial_ord=int(o), seq=int(s),  # noqa: REPRO003 -- a snapshot's JSON field, a host value
                        kind=str(k), client_id=int(c))  # noqa: REPRO003 -- a snapshot's JSON field, a host value
            for t, o, s, k, c in meta["merged"]["events"]]
    heapq.heapify(heap)
    ev.merged._heap = heap
    counts: Dict[int, int] = {}
    for e in heap:
        counts[e.trial_ord] = counts.get(e.trial_ord, 0) + 1
    ev.merged._count = counts

    stats = meta["stats"]
    sched.stats.admitted = int(stats["admitted"])
    sched.stats.retired = int(stats["retired"])
    sched.stats.steps = int(stats["steps"])
    sched.stats.occupancy_sum = float(stats["occupancy_sum"])
    sched.stats.admission_log = [tuple(t) for t in stats["admission_log"]]
    sched._sync_steps = int(meta["sync_steps"])
