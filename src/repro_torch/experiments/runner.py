"""Multi-trial sweep execution: T independent FL trainings as ONE workload
(counterpart of ``repro.experiments.runner``).

The unit of progress for FL hyper-parameter research is the *trial* — one
(preference, aggregator, dataset, seed, M0/E0) cell of the paper's tables —
and trials share no state, only hardware.  The sequential engine runs them
one ``FLServer.run()`` at a time; the vectorized engine adds a trials axis
on top of the cohort machinery of ``runtime/batched.py`` and runs all of
them per virtual round:

  1. PLAN   — every live trial plans its sync round through the engine's own
              ``plan_sync_round``, consuming its private server/system rngs
              exactly as a standalone run would.
  2. PACK   — every trial's included clients are materialized
              (``materialize_streams``, the rng contract of the sequential
              path) and packed into one flat cohort: grouped by model,
              size-bucketed by pow2 step count, the client axis padded to a
              pow2.  One ``cohort_scan`` per bucket trains clients of MANY
              trials side by side, each lane from its own trial's global
              params (``global_in_axis=0``).  A bucket's batches reach the
              device in one copy per array.
  3. REDUCE — every FedAvg trial's weighted mean runs as ONE ``fed_reduce``
              launch per model group over the packed flat cohort (segment
              ids = trial slots, raw example counts normalized in the
              kernel, the int8 upload round trip of compressed trials
              against each trial's dispatch-time globals).  Non-FedAvg
              trials hand their per-client trees to their own aggregator,
              which reduces through a T=1 ``fed_reduce``.
  4. STEP   — every due trial's evaluation runs as one stacked evaluation
              per (model, dataset) group (``evaluate_stacked``), then each
              trial's FedTune controller steps its (M, E); finished trials
              drop out of the pack.

Async/buffered trials vectorize through ``run_vectorized_events``: ONE
merged virtual-clock event queue spans all live trials (events tagged with
trial ordinal; ties ordered (time, ordinal, per-trial push seq)).  Each
macro-step advances every live trial to its next pending client completion,
packs those arrivals into one flat cohort (each lane from ITS trial's
dispatch snapshot) and routes each trained lane back to its trial's
FedAsync mixer (``fed_aggregate``) or FedBuff buffer (``fed_reduce`` at a
flush) through the engine's own plan/apply/finish methods.

Parity contract (tests/test_torch_sweep.py): a vectorized sweep gives every
trial the FedTune (M, E) trajectory, cost totals and dispatch/staleness
logs of its standalone ``FLServer.run()``; these come from counts,
decisions and numpy clocks.  Params are not bit-identical between a packed
lane and a standalone run: a batched product does not give each lane the
bits of a single product, and an int8 upload round trip can turn a
last-bit difference into a quantisation step.  So accuracies are equal on
the CPU (the tests) but may differ by an eval point on the card: at full
width the int8 FedAvg lane's params were 6.2e-4 from its standalone run's
and one of 512 points flipped in one of 5 rounds (ROADMAP.md section 3,
departure 7).

``torch`` cannot reproduce ``jax.random``: the entry points take an optional
``init_params(spec) -> numpy tree`` (e.g. the reference's
``model.init(PRNGKey(seed))``); without it a trial starts from the port's
seeded ``model.init(seed, device)``.  Every entry point runs on ``device``
(default ``cuda``).  Spans and metrics (``repro_torch.obs``) sit at the
reference's sites: PLAN/PACK/TRAIN/APPLY/EVAL per packed round,
COLLECT/PACK/APPLY/EVAL per event macro-step, and the fused reduce's
counters.  The sharded pack is not ported (ROADMAP.md queue 1, item 15).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs, perf
from repro_torch.configs.paper_models import MLPConfig
from repro_torch.core import CostModel, FedTune, FedTuneConfig, Preference
from repro_torch.core.tuner import FixedTuner, HyperParams
from repro_torch.data import cifar100_like, emnist_like, speech_command_like
from repro_torch.device import resolve_device
from repro_torch.experiments.grid import TrialSpec
from repro_torch.federated import FLConfig, FLServer, get_aggregator
from repro_torch.federated.aggregation import (ClientUpdate, _flatten,
                                               _unflatten)
from repro_torch.federated.compression import compress_delta_lanes, lane_mask
from repro_torch.federated.evaluation import eval_due, evaluate_stacked
from repro_torch.federated.server import FLResult, RoundRecord
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import build_model
from repro_torch.optim.optimizers import get_optimizer
from repro_torch.runtime.batched import (_pow2, _stack_streams,
                                         bucket_by_steps, cohort_scan,
                                         make_client_step,
                                         materialize_streams,
                                         note_pack_metrics, to_device)
from repro_torch.runtime.engine import EventDrivenRuntime, RuntimeConfig
from repro_torch.runtime.events import (FAILURE, MergedEventQueue,
                                        TrialQueueView)
from repro_torch.runtime.profiles import ChurnSchedule, sample_fleet
from repro_torch.tree import leaves, tree_map, tree_stack
from repro_torch.weights import params_from_numpy

ENGINES = ("vectorized", "sequential")
PACKS = ("batched", "sharded")

InitFn = Optional[Callable[[TrialSpec], Any]]

_DATASET_FNS = {"speech_command": speech_command_like, "emnist": emnist_like,
                "cifar100": cifar100_like}
_dataset_cache: Dict[tuple, Any] = {}
_model_cache: Dict[tuple, Any] = {}
_optimizer_cache: Dict[tuple, Any] = {}


# ---------------------------------------------------------------------------
# trial construction (shared caches, so T trials over one dataset family
# share one Model/Optimizer object and pack into one group)
# ---------------------------------------------------------------------------

def _dataset_for(spec: TrialSpec):
    key = (spec.dataset, spec.reduced, spec.seed)
    if key not in _dataset_cache:
        _dataset_cache[key] = _DATASET_FNS[spec.dataset](
            reduced=spec.reduced, seed=spec.seed)
    return _dataset_cache[key]


def _model_for(spec: TrialSpec):
    """The trial's ``hidden=(48,)`` MLP and its parameter count."""
    ds = _dataset_for(spec)
    key = (spec.dataset, spec.reduced)
    if key not in _model_cache:
        in_dim = int(np.prod(ds.spec.shape))
        model = build_model(MLPConfig(
            name=f"mlp_{spec.dataset}{'_r' if spec.reduced else ''}",
            in_dim=in_dim, hidden=(48,), n_classes=ds.spec.n_classes))
        n_params = sum(p.numel() for p in leaves(model.init(0, "cpu")))
        _model_cache[key] = (model, n_params)
    return _model_cache[key]


def _optimizer_for(spec: TrialSpec):
    key = ("sgd", spec.lr, 0.9)
    if key not in _optimizer_cache:
        _optimizer_cache[key] = get_optimizer("sgd", spec.lr, momentum=0.9)
    return _optimizer_cache[key]


def build_server(spec: TrialSpec, device=None) -> FLServer:
    """A fresh FLServer for one trial on ``device`` (fresh aggregator/
    tuner/selector/rng state; model, optimizer, and dataset shared through
    the caches)."""
    ds = _dataset_for(spec)
    model, n_params = _model_for(spec)
    flops = model.flops_per_example or 2 * n_params
    tuner = (FedTune(FedTuneConfig(preference=Preference(*spec.preference)),
                     HyperParams(spec.m0, spec.e0))
             if spec.tuner == "fedtune" else FixedTuner())
    # a fleet exists iff the trial has any system heterogeneity OR a
    # failure/churn model to hang onto it
    needs_fleet = (spec.het != "homogeneous" or spec.failure_rate > 0.0
                   or spec.churn is not None)
    fleet = (sample_fleet(spec.het, ds.n_clients, seed=spec.seed)
             if needs_fleet else None)
    if fleet is not None and spec.failure_rate > 0.0:
        fleet.failure = np.full(ds.n_clients, spec.failure_rate)
        fleet.failure_seed = spec.seed
    if fleet is not None and spec.churn is not None:
        fleet.churn = ChurnSchedule.from_string(spec.churn, seed=spec.seed)
    return FLServer(
        model, ds, get_aggregator(spec.aggregator), _optimizer_for(spec),
        CostModel(flops_per_example=flops, param_count=n_params),
        FLConfig(m=spec.m0, e=spec.e0, batch_size=spec.batch_size,
                 target_accuracy=spec.target_accuracy,
                 max_rounds=spec.rounds, eval_points=spec.eval_points,
                 prox_mu=spec.prox_mu, seed=spec.seed,
                 compression=spec.compression),
        tuner=tuner, fleet=fleet,
        runtime_config=RuntimeConfig(mode=spec.mode,
                                     client_exec=spec.client_exec),
        device=device)


def _initial_params(srv: FLServer, spec: TrialSpec, init_params: InitFn):
    """``init_params(spec)`` (a numpy tree) on the server's device, or the
    port's seeded init."""
    if init_params is None:
        return srv.model.init(spec.seed, srv.device)
    return params_from_numpy(init_params(spec), srv.device)


def _check_pack(pack: str):
    if pack not in PACKS:
        raise ValueError(f"unknown pack {pack!r}; valid packs: "
                         + ", ".join(PACKS))
    if pack == "sharded":
        raise NotImplementedError(
            "pack 'sharded' is not ported yet: it comes with the multi-GPU "
            "slice (ROADMAP.md queue 1, item 15); use pack='batched'")


# ---------------------------------------------------------------------------
# results
# ---------------------------------------------------------------------------

@dataclass
class TrialResult:
    """One finished trial, flattened for the JSONL store.

    ``history_*`` are the per-round trajectories the parity tests compare;
    ``dispatch_log``/``staleness_log`` (async/buffered only) record every
    dispatch as (virtual time, client id, model version) and the staleness
    of every applied arrival.  ``params`` (the final global params, on the
    trial's device) and ``local_steps`` (local optimizer steps the
    vectorized engines ran; 0 from ``run_trial``) are the port's additions; like the logs, ``to_record`` leaves them out, so the
    store schema is the reference's."""
    spec: TrialSpec
    reached: bool
    rounds: int
    final_accuracy: float
    final_m: int
    final_e: float
    cost: Tuple[float, float, float, float]
    sim_time: float
    wall: float
    engine: str
    history_m: List[int]
    history_e: List[float]
    history_acc: List[float]
    dispatch_log: List[tuple] = field(default_factory=list)
    staleness_log: List[int] = field(default_factory=list)
    params: Any = None
    local_steps: int = 0

    @classmethod
    def from_flresult(cls, spec: TrialSpec, res: FLResult, wall: float,
                      engine: str, local_steps: int = 0) -> "TrialResult":
        return cls(
            spec=spec, reached=res.reached_target, rounds=res.rounds,
            final_accuracy=float(res.final_accuracy), final_m=res.final_m,
            final_e=float(res.final_e), cost=res.total_cost.as_tuple(),
            sim_time=float(res.sim_time), wall=wall, engine=engine,
            history_m=[r.m for r in res.history],
            history_e=[float(r.e) for r in res.history],
            history_acc=[float(r.accuracy) for r in res.history],
            dispatch_log=list(res.dispatch_log or []),
            staleness_log=list(res.staleness_log or []),
            params=res.params, local_steps=local_steps)

    def to_record(self) -> dict:
        return {
            "key": self.spec.key(), "status": "done",
            "baseline_key": self.spec.baseline_key(),
            "spec": self.spec.to_dict(),
            "reached": self.reached, "rounds": self.rounds,
            "final_accuracy": self.final_accuracy,
            "final_m": self.final_m, "final_e": self.final_e,
            "cost": list(self.cost), "sim_time": self.sim_time,
            "wall": self.wall, "engine": self.engine,
            "history_m": self.history_m, "history_e": self.history_e,
            "history_acc": self.history_acc,
        }


def run_trial(spec: TrialSpec, *, device=None,
              init_params: InitFn = None) -> TrialResult:
    """One trial, the single-process way: a full ``FLServer.run()``."""
    srv = build_server(spec, device)
    params = _initial_params(srv, spec, init_params)
    t0 = time.perf_counter()
    res = srv.run(params)
    return TrialResult.from_flresult(spec, res, time.perf_counter() - t0,
                                     "sequential")


# ---------------------------------------------------------------------------
# the vectorized multi-trial engine
# ---------------------------------------------------------------------------

def _multi_cohort_fn(model, optimizer, prox_mu: float):
    """The packed-cohort step: the shared stacked step with PER-CLIENT
    reference params (``global_in_axis=0``), each lane starting local
    training from its own trial's global model."""
    cohort_step = make_client_step(model, optimizer, prox_mu)

    def run(global_b, xs, ys, masks, active):
        opt_b = optimizer.init(global_b)
        return cohort_scan(cohort_step, global_b, opt_b, xs, ys, masks,
                           active, global_b, global_in_axis=0)

    return run


def _flatten_cohort(params_b):
    """(M, N) rows in ``jax.tree.flatten`` leaf order (``b`` before ``w``),
    the layout of ``aggregation._flatten`` and of the int8 leaf scales."""
    ls = leaves(params_b)
    m = ls[0].shape[0]
    return torch.cat([l.reshape(m, -1) for l in ls], dim=1)


@dataclass
class _Cohort:
    cids: List[int]
    streams: List[list]
    n_steps: List[int]
    sizes: List[int]
    trained: List[Any] = field(default_factory=list)   # per-client trees
    flat_rows: List[Any] = field(default_factory=list)  # per-client (N,) rows
    losses: List[float] = field(default_factory=list)
    agg_params: Any = None    # set by the fused reduce


@dataclass(eq=False)     # identity semantics: trials are packed by object
class _LiveTrial:
    spec: TrialSpec
    srv: FLServer
    eng: EventDrivenRuntime
    hp: HyperParams
    params: Any
    round_idx: int = 0
    accuracy: float = 0.0
    reached: bool = False
    done: bool = False
    wall: float = 0.0
    local_steps: int = 0
    history: List[RoundRecord] = field(default_factory=list)
    plan: Any = None
    cohort: Optional[_Cohort] = None
    round_cost: Any = None     # set by _reduce_round, consumed by _finish_round
    _meta: Any = None          # cached _flatten meta (model-constant)


def _make_live(spec: TrialSpec, device, init_params: InitFn) -> _LiveTrial:
    srv = build_server(spec, device)
    eng = EventDrivenRuntime(srv, fleet=srv.fleet,
                             config=srv.runtime_config or RuntimeConfig())
    eng.trace_label = spec.key()
    return _LiveTrial(spec=spec, srv=srv, eng=eng,
                      hp=HyperParams(m=spec.m0, e=spec.e0),
                      params=_initial_params(srv, spec, init_params))


def _group_key(tr) -> tuple:
    return (id(tr.srv.model), id(tr.srv.optimizer), tr.srv.config.prox_mu,
            tr.srv.config.batch_size)


def _run_group_batched(ents: List[Tuple[_LiveTrial, int]]):
    """Train one model-group's packed entries; results land back in each
    trial's cohort.  FedAvg trials keep their clients as rows of the
    bucket's flat (M, N) matrix (their aggregation is one fused
    ``fed_reduce`` over those rows in ``_fused_sync_reduce``); other
    aggregators get per-client tree slices.  Each trial's global params
    enter the pack through one per-round stack and an on-device gather per
    bucket.  Upload-compressed lanes of non-FedAvg trials go through the
    round trip against their trial's global params (``compress_delta_
    lanes``); compressed FedAvg lanes are masked off, because their round
    trip runs inside the fused reduce."""
    tr0 = ents[0][0]
    model, opt = tr0.srv.model, tr0.srv.optimizer
    bs = tr0.srv.config.batch_size
    dev = tr0.srv.device
    run = _multi_cohort_fn(model, opt, tr0.srv.config.prox_mu)

    trials: List[_LiveTrial] = []
    slot: Dict[int, int] = {}
    for tr, _ in ents:
        if id(tr) not in slot:
            slot[id(tr)] = len(trials)
            trials.append(tr)
    stacked = tree_stack([tr.params for tr in trials])

    n_steps = [tr.cohort.n_steps[j] for tr, j in ents]
    for t_pad, idx in sorted(bucket_by_steps(n_steps).items()):
        sel = [ents[i] for i in idx]
        m_pad = _pow2(len(sel))    # bound the set of (T, M) pack shapes
        if obs.enabled():
            note_pack_metrics(t_pad, m_pad, len(sel),
                              sum(n_steps[i] for i in idx))
        streams = [tr.cohort.streams[j] for tr, j in sel]
        xs, ys, masks, active = to_device(dev, *_stack_streams(
            streams + [[]] * (m_pad - len(sel)), bs, t_pad))
        slots = torch.tensor([slot[id(tr)] for tr, _ in sel]
                             + [0] * (m_pad - len(sel)), device=dev)
        global_b = tree_map(lambda s: s[slots], stacked)
        params_b, last_loss = run(global_b, xs, ys, masks, active)
        mask = lane_mask([tr.srv.config.compression
                          if tr.srv.aggregator.name != "fedavg" else None
                          for tr, _ in sel]
                         + [None] * (m_pad - len(sel)))
        if mask is not None:
            params_b = compress_delta_lanes(global_b, params_b, mask)
        flat = _flatten_cohort(params_b)
        ll = last_loss.cpu().numpy()
        for k, (tr, j) in enumerate(sel):
            if tr.srv.aggregator.name == "fedavg":
                tr.cohort.flat_rows[j] = flat[k]
            else:
                tr.cohort.trained[j] = tree_map(lambda p, k=k: p[k],
                                                params_b)
            tr.cohort.losses[j] = float(ll[k])


def _fedavg_from_rows(tr: _LiveTrial) -> Any:
    """FedAvg straight from the packed cohort's flat rows, as a T=1
    ``fed_reduce`` (raw counts normalized in the kernel, the int8 round
    trip fused when the trial compresses uploads): one lane of
    ``_fused_sync_reduce`` on its own."""
    co = tr.cohort
    gflat, meta = _flatten(tr.params)
    if tr._meta is None:
        tr._meta = meta
    rows = [r if r is not None else gflat
            for r in co.flat_rows]     # zero-step clients stay at global
    dev = gflat.device
    w = torch.tensor(co.sizes, dtype=torch.float32, device=dev)
    seg = torch.zeros(len(rows), dtype=torch.int32, device=dev)
    comp = tr.srv.config.compression not in (None, "none")
    out = kernel_ops.fed_reduce(
        w, torch.stack(rows), seg, 1, normalize=True,
        leaf_sizes=tuple(meta[2]) if comp else None,
        quant_ref=gflat[None, :] if comp else None,
        quant_enabled=(torch.ones(len(rows), dtype=torch.bool, device=dev)
                       if comp else None))
    return _unflatten(out[0], tr._meta)


def _fused_sync_reduce(live: List[_LiveTrial]):
    """ONE ``fed_reduce`` launch per model group covering every FedAvg
    trial's aggregation: each trial is a segment (lane) of the packed
    (M, N) row matrix (T = pow2 of the group's trials, rows padded to a
    pow2 with weight 0 and segment 0), raw example counts are normalized
    per segment in the kernel, and compressed trials' int8 upload round
    trips run against their own stacked global params in the same call.
    Fills ``cohort.agg_params``; ``_reduce_round`` consumes it.  The
    kernel folds each segment's rows left to right in pack order, so lane
    t equals a T=1 reduce of that trial's rows bit for bit."""
    todo = [tr for tr in live
            if tr.cohort is not None and tr.cohort.cids
            and tr.cohort.agg_params is None
            and tr.srv.aggregator.name == "fedavg"]
    groups: Dict[int, List[_LiveTrial]] = {}
    for tr in todo:
        groups.setdefault(id(tr.srv.model), []).append(tr)
    for grp in groups.values():
        t_pad = _pow2(len(grp))
        rows, w, seg, en, qrefs = [], [], [], [], []
        meta = None
        for s, tr in enumerate(grp):
            co = tr.cohort
            gflat, meta = _flatten(tr.params)
            if tr._meta is None:
                tr._meta = meta
            qrefs.append(gflat)
            comp = tr.srv.config.compression not in (None, "none")
            for j in range(len(co.cids)):
                r = co.flat_rows[j]
                rows.append(r if r is not None else gflat)
                w.append(co.sizes[j])
                seg.append(s)
                en.append(comp)
        m_pad = _pow2(len(rows))
        n = rows[0].shape[0]
        dev = rows[0].device
        rows += [torch.zeros(n, dtype=rows[0].dtype, device=dev)] * (
            m_pad - len(rows))
        pad = m_pad - len(w)
        w += [0.0] * pad                  # zero-weight rows are bit-neutral
        seg += [0] * pad
        en += [False] * pad
        quant = any(en)
        if quant:
            qrefs += [torch.zeros(n, dtype=qrefs[0].dtype, device=dev)] * (
                t_pad - len(qrefs))
        if obs.enabled():
            obs.registry.inc("reduce_fused_dispatches")
            obs.registry.sample("reduce_rows", m_pad)
            obs.registry.sample("reduce_lanes", len(grp))
        with obs.span("REDUCE", phase="apply", n_lanes=len(grp),
                      n_rows=m_pad):
            out = kernel_ops.fed_reduce(
                torch.tensor(w, dtype=torch.float32, device=dev),
                torch.stack(rows),
                torch.tensor(seg, dtype=torch.int32, device=dev), t_pad,
                normalize=True,
                leaf_sizes=tuple(meta[2]) if quant else None,
                quant_ref=torch.stack(qrefs) if quant else None,
                quant_enabled=(torch.tensor(en, dtype=torch.bool,
                                            device=dev)
                               if quant else None))
        for s, tr in enumerate(grp):
            tr.cohort.agg_params = _unflatten(out[s], tr._meta)


def _reduce_round(tr: _LiveTrial):
    """Per-trial selector updates, aggregation, and cost accounting: the
    pre-evaluation half of the engine's sync round.  Evaluation is not
    here: the sweep loop evaluates every due trial in one stacked
    evaluation between reduce and finish."""
    srv = tr.srv
    if tr.cohort is not None and tr.cohort.cids:
        co = tr.cohort
        for j, cid in enumerate(co.cids):
            srv.selector.update(int(cid), co.losses[j], co.sizes[j])
        if co.agg_params is not None:   # the fused reduce
            tr.params = co.agg_params
        elif srv.aggregator.name == "fedavg":
            tr.params = _fedavg_from_rows(tr)
        else:
            updates = [
                ClientUpdate(
                    params=(co.trained[j] if co.trained[j] is not None
                            else tr.params),
                    n_examples=co.sizes[j], n_steps=co.n_steps[j],
                    last_loss=co.losses[j], client_id=int(cid))
                for j, cid in enumerate(co.cids)]
            tr.params = srv.aggregator(tr.params, updates)
    tr.round_cost = tr.eng.account_sync_round(tr.plan, tr.hp)


def _finish_round(tr: _LiveTrial, wall: float,
                  accuracy: Optional[float] = None):
    """Record the round and step the trial's own controller: the
    post-evaluation half of the engine's sync round.  ``accuracy`` is the
    trial's lane of the stacked evaluation (None when this round is not on
    the eval schedule: the last measured accuracy carries forward)."""
    srv, cfg = tr.srv, tr.srv.config
    round_cost = tr.round_cost
    r = tr.round_idx
    if accuracy is not None:
        tr.accuracy = accuracy
    tr.history.append(RoundRecord(
        r, tr.hp.m, tr.hp.e, tr.accuracy, round_cost, wall,
        sim_time=tr.eng.clock.now, n_updates=len(tr.plan.included)))
    tr.round_idx += 1
    tr.cohort = None
    tr.plan = None
    tr.round_cost = None
    if tr.accuracy >= cfg.target_accuracy:
        tr.reached = True
        tr.done = True
        return
    tr.hp = srv.tuner.on_round(r, tr.accuracy, round_cost,
                               srv.cost_model.total, tr.hp)
    tr.hp = tr.hp.clamped(srv.dataset.n_clients, 100.0)
    if tr.round_idx >= cfg.max_rounds:
        tr.done = True


def _to_result(tr: _LiveTrial, engine: str) -> TrialResult:
    res = FLResult(
        reached_target=tr.reached, rounds=len(tr.history),
        final_accuracy=tr.accuracy,
        total_cost=tr.srv.cost_model.total.copy(), history=tr.history,
        final_m=tr.hp.m, final_e=tr.hp.e, params=tr.params,
        sim_time=tr.eng.clock.now)
    return TrialResult.from_flresult(tr.spec, res, tr.wall, engine,
                                     tr.local_steps)


def _sync_round_step(live: List[_LiveTrial], step_idx: int = 0) -> int:
    """Advance the given live sync trials by ONE packed virtual round
    (plan -> pack -> train -> reduce -> eval -> finish).  The live set is
    whatever the caller says it is (the fixed-set sweep passes every
    unfinished trial, the continuous-batching scheduler its admitted
    lanes), and every pack/eval shape is keyed off that set.  Trials that
    end this round come back with ``done`` set; retiring them is the
    caller's job.  ``step_idx`` only labels the round's metrics.  Returns
    the number of packed client entries."""
    t0 = time.perf_counter()
    if obs.enabled():
        obs.registry.sample("lanes_live", len(live), step=step_idx,
                            engine="sync")
    # 1. plan every live trial's round (per-trial rng streams)
    with obs.span("PLAN", phase="plan", n_trials=len(live)):
        for tr in live:
            v0 = tr.eng.clock.now
            tr.plan = tr.eng.plan_sync_round(tr.hp)
            tr.eng.clock.advance_to(tr.eng.clock.now + tr.plan.round_time)
            if obs.enabled():
                obs.record("round", phase="round", trial=tr.spec.key(),
                           round_idx=tr.round_idx,
                           virtual=(v0, tr.eng.clock.now),
                           n_included=len(tr.plan.included),
                           n_active=len(tr.plan.active))
    # 2. materialize batch streams (the rng contract) and pack
    entries: List[Tuple[_LiveTrial, int]] = []
    with obs.span("PACK", phase="pack", n_trials=len(live)):
        for tr in live:
            cids = tr.plan.train_cids
            if not cids:
                tr.cohort = None
                continue
            data = [tr.srv.dataset.client_data(c) for c in cids]
            streams, n_steps = materialize_streams(
                data, tr.srv.config.batch_size, tr.hp.e, tr.srv.rng)
            tr.local_steps += sum(n_steps)
            tr.cohort = _Cohort(cids=cids, streams=streams, n_steps=n_steps,
                                sizes=[len(y) for _, y in data],
                                trained=[None] * len(cids),
                                flat_rows=[None] * len(cids),
                                losses=[0.0] * len(cids))
            entries.extend((tr, j) for j in range(len(cids)))
    # 3. group by model and train each group's packed cohort
    groups: Dict[tuple, List[Tuple[_LiveTrial, int]]] = {}
    for ent in entries:
        groups.setdefault(_group_key(ent[0]), []).append(ent)
    with perf.timed("train"), obs.span("TRAIN", phase="train",
                                       n_entries=len(entries),
                                       n_groups=len(groups)):
        for ents in groups.values():
            _run_group_batched(ents)
    # 4. per-trial aggregation + accounting, then ONE stacked eval of every
    #    due trial, then per-trial record + controller step
    with obs.span("APPLY", phase="apply", n_trials=len(live)):
        _fused_sync_reduce(live)       # one launch per model group
        for tr in live:
            _reduce_round(tr)
    due = [tr for tr in live
           if eval_due(tr.round_idx, tr.srv.config.eval_every,
                       tr.srv.config.max_rounds)]
    with obs.span("EVAL", phase="eval", n_due=len(due)):
        accs = evaluate_stacked(
            [(tr.srv.model, tr.srv.dataset, tr.srv.config.eval_points,
              tr.params) for tr in due], pad_pow2=True)
    acc_of = {id(tr): a for tr, a in zip(due, accs)}
    wall = time.perf_counter() - t0
    if obs.enabled():
        obs.counter("t_sim", max(tr.eng.clock.now for tr in live))
    for tr in live:
        tr.wall += wall / len(live)
        _finish_round(tr, wall / len(live), acc_of.get(id(tr)))
    return len(entries)


def _run_vectorized_sync(specs: Sequence[TrialSpec], *,
                         on_result: Optional[Callable] = None,
                         verbose: bool = False, device=None,
                         init_params: InitFn = None) -> List[TrialResult]:
    """Run every sync-mode trial concurrently, one packed cohort per
    virtual round (``_sync_round_step``) over the set of unfinished
    trials until all are done."""
    dev = resolve_device(device)
    trials = [_make_live(s, dev, init_params) for s in specs]
    results: List[TrialResult] = [None] * len(trials)
    engine = "vectorized/batched"
    n_rounds = 0
    while True:
        live = [tr for tr in trials if not tr.done]
        if not live:
            break
        n_entries = _sync_round_step(live, step_idx=n_rounds)
        for tr in live:
            if tr.done:
                res = _to_result(tr, engine)
                results[trials.index(tr)] = res
                if on_result is not None:
                    on_result(res)
        n_rounds += 1
        if verbose and n_rounds % 10 == 0:
            done = sum(tr.done for tr in trials)
            print(f"  sweep round {n_rounds}: {done}/{len(trials)} trials "
                  f"done, {n_entries} clients packed", flush=True)
    return results


# ---------------------------------------------------------------------------
# the merged-queue event engine (async / buffered trials)
# ---------------------------------------------------------------------------

@dataclass(eq=False)     # identity semantics: trials are packed by object
class _EventTrial:
    """One live async/buffered trial of a merged-queue sweep: its server,
    runtime engine, event-loop state, and the view binding it onto the
    sweep's merged event queue."""
    spec: TrialSpec
    srv: FLServer
    eng: EventDrivenRuntime
    view: TrialQueueView
    st: Any = None             # repro_torch.runtime.engine.EventLoopState
    done: bool = False
    wall: float = 0.0
    local_steps: int = 0


@dataclass
class _Lane:
    """One packed arrival: trial + its in-flight record + the batch stream
    materialized at the standalone loop's exact rng point.  ``params`` and
    ``loss`` are filled by the cohort training."""
    tr: _EventTrial
    fl: Any                    # repro_torch.runtime.engine._InFlight
    stream: list
    n_steps: int
    params: Any = None
    loss: float = 0.0


def _make_event_live(spec: TrialSpec, merged: MergedEventQueue,
                     trial_ord: int, device,
                     init_params: InitFn) -> _EventTrial:
    srv = build_server(spec, device)
    eng = EventDrivenRuntime(srv, fleet=srv.fleet,
                             config=srv.runtime_config or RuntimeConfig())
    eng.trace_label = spec.key()
    view = TrialQueueView(merged, trial_ord)
    tr = _EventTrial(spec=spec, srv=srv, eng=eng, view=view)
    # initial concurrency dispatches straight into the merged queue
    tr.st = eng.init_event_state(_initial_params(srv, spec, init_params),
                                 queue=view)
    return tr


def _coalesce_buckets(buckets: Dict[int, List[int]],
                      min_lanes: int = 4) -> Dict[int, List[int]]:
    """Merge under-filled step buckets upward into the next-larger one.

    The event pack holds at most one lane per trial, so strict
    ``bucket_by_steps`` grouping would often produce singleton buckets, one
    step sequence per lane.  Promoting a small bucket's lanes into a larger
    t_pad only adds masked (frozen-state) steps; full buckets are left
    alone."""
    out: Dict[int, List[int]] = {}
    pending: List[int] = []
    for t_pad in sorted(buckets):
        pending.extend(buckets[t_pad])
        if len(pending) >= min_lanes or t_pad == max(buckets):
            out[t_pad] = pending     # the max bucket absorbs any tail
            pending = []
    return out


def _run_event_group(lanes: List[_Lane], min_lanes: int = 4):
    """Train one model-group's packed arrivals: one lane per trial, each
    starting local training from ITS trial's dispatch-snapshot params
    (``global_in_axis=0`` also anchors the FedProx term there, as
    ``local_train`` does).  Buckets by pow2 step count (small buckets
    coalesced upward; ``min_lanes`` is keyed off the LIVE lane count) and
    pads the lane axis to a pow2.  Trained lanes stay on the device as
    views of the bucket's stacked params."""
    tr0 = lanes[0].tr
    model, opt = tr0.srv.model, tr0.srv.optimizer
    bs = tr0.srv.config.batch_size
    dev = tr0.srv.device
    run = _multi_cohort_fn(model, opt, tr0.srv.config.prox_mu)
    buckets = _coalesce_buckets(
        bucket_by_steps([ln.n_steps for ln in lanes]), min_lanes=min_lanes)
    for t_pad, idx in sorted(buckets.items()):
        sel = [lanes[i] for i in idx]
        m_pad = _pow2(len(sel))
        if obs.enabled():
            note_pack_metrics(t_pad, m_pad, len(sel),
                              sum(ln.n_steps for ln in sel))
        xs, ys, masks, active = to_device(dev, *_stack_streams(
            [ln.stream for ln in sel] + [[]] * (m_pad - len(sel)),
            bs, t_pad))
        global_b = tree_stack([ln.fl.params for ln in sel]
                               + [sel[0].fl.params] * (m_pad - len(sel)))
        params_b, last_loss = run(global_b, xs, ys, masks, active)
        # upload-compressed lanes: the round trip against the lane's
        # dispatch snapshot, what _client_update does per arrival
        mask = lane_mask([ln.tr.srv.config.compression for ln in sel]
                         + [None] * (m_pad - len(sel)))
        if mask is not None:
            params_b = compress_delta_lanes(global_b, params_b, mask)
        ll = last_loss.cpu().numpy()
        for k, ln in enumerate(sel):
            ln.params = tree_map(lambda p, k=k: p[k], params_b)
            ln.loss = float(ll[k])


class _EventEngine:
    """Merged-queue engine state: ONE merged virtual-clock event queue
    spanning every live trial, with trial ordinals handed out at admission.
    Admission order IS the merged queue's cross-trial tie order (the
    fixed-set wrapper admits in sorted-key order).  A trial's own event
    sequence depends only on its private rngs and clock, never on which
    other trials share the queue."""

    def __init__(self, device=None, init_params: InitFn = None):
        self.device = resolve_device(device)
        self.init_params = init_params
        self.merged = MergedEventQueue()
        self.by_ord: Dict[int, _EventTrial] = {}
        self.n_steps = 0
        # ordinals are handed out monotonically and never reused
        self.next_ord = 0

    def admit(self, spec: TrialSpec) -> _EventTrial:
        """Bring one async/buffered trial live on the merged queue (its
        initial concurrency dispatches push events immediately)."""
        if spec.mode not in ("async", "buffered"):
            raise ValueError(
                f"trial {spec.key()!r} is not an event-driven trial "
                "(the merged-queue engine covers the async/buffered modes; "
                "sync trials pack per round via run_vectorized)")
        trial_ord = self.next_ord
        self.next_ord += 1
        tr = _make_event_live(spec, self.merged, trial_ord, self.device,
                              self.init_params)
        self.by_ord[trial_ord] = tr
        return tr

    def end_trial(self, tr: _EventTrial) -> None:
        """Retire one trial: account its tail window, mark it done, and
        drop its pending events from the merged queue."""
        tr.eng.account_event_tail(tr.st)
        tr.done = True
        self.merged.drop_trial(tr.view.trial_ord)

    def macro_step(self, live: List[_EventTrial],
                   on_done: Callable[[_EventTrial], None]) -> int:
        """One COLLECT/PACK/APPLY macro-step over the given live trials.

        (1) COLLECT: pop the merged queue in (time, ordinal, seq) order,
        advancing every live trial to its next pending arrival; dropouts
        and failures are handled inline, and events of trials that already
        contributed an arrival are deferred untouched (FedAsync/FedBuff
        state is sequential per trial).  Each collected arrival's batch
        stream is materialized at the point the standalone loop would
        consume the trial's server rng.  (2) PACK: all collected arrivals
        train as one flat cohort per model group.  (3) APPLY, per trial on
        the host: selector update, FedAsync mixing / FedBuff buffering,
        accounting, one stacked evaluation of every aggregating-and-due
        trial, FedTune step, and concurrency refill, through the engine's
        own event-loop methods.

        ``on_done(tr)`` fires for every trial that ends during the step.
        Returns the number of packed arrivals."""
        self.n_steps += 1
        merged, by_ord = self.merged, self.by_ord

        def end(tr: _EventTrial):
            self.end_trial(tr)
            on_done(tr)

        step_idx = self.n_steps - 1
        t0 = time.perf_counter()
        if obs.enabled():
            obs.registry.sample("lanes_live", len(live), step=step_idx,
                                engine="events")
        # 1. COLLECT one pending arrival per live trial
        lanes: List[_Lane] = []
        packed = set()
        stash = []
        with obs.span("COLLECT", phase="collect", n_live=len(live)) as sp:
            while merged and len(packed) < len(live):
                ev = merged.pop()
                tr = by_ord[ev.trial_ord]
                if tr.done:
                    continue           # stale event of a finished trial
                if id(tr) in packed:
                    stash.append(ev)   # defer: this trial already packed
                    continue
                tr.eng.clock.advance_to(ev.time)
                if ev.kind == FAILURE:  # hard failure: retry inline, refill
                    tr.eng.handle_failure(tr.st, ev, queue=tr.view)
                    tr.eng.fill_event_concurrency(tr.st, tr.eng.clock.now,
                                                  queue=tr.view)
                    continue
                fl = tr.eng.plan_event(tr.st, ev)
                if fl is None:         # dropout: refill and keep collecting
                    tr.eng.fill_event_concurrency(tr.st, tr.eng.clock.now,
                                                  queue=tr.view)
                    continue
                data = [tr.srv.dataset.client_data(fl.client_id)]
                streams, n_steps = materialize_streams(
                    data, tr.srv.config.batch_size, fl.e, tr.srv.rng)
                tr.local_steps += n_steps[0]
                lanes.append(_Lane(tr=tr, fl=fl, stream=streams[0],
                                   n_steps=n_steps[0]))
                packed.add(id(tr))
            for ev in stash:
                merged.requeue(ev)
            sp.set(n_lanes=len(lanes), n_deferred=len(stash))
        # a live trial with nothing queued ends exactly as the standalone
        # loop does on an empty queue
        for tr in live:
            if not tr.done and id(tr) not in packed and not tr.view:
                end(tr)
        # 2. PACK: train all collected arrivals as one cohort per model group
        groups: Dict[tuple, List[_Lane]] = {}
        for ln in lanes:
            if ln.n_steps == 0:        # zero-step client: stays at snapshot
                ln.params, ln.loss = ln.fl.params, 0.0
                continue
            groups.setdefault(_group_key(ln.tr), []).append(ln)
        with perf.timed("train"), obs.span("PACK", phase="train",
                                           n_lanes=len(lanes),
                                           n_groups=len(groups)):
            for group in groups.values():
                _run_event_group(group, min_lanes=min(4, len(live)))
        # 3. APPLY per trial, in collect (= merged pop) order: fold every
        #    lane into its trial's global model, evaluate every
        #    aggregating-and-due trial in ONE stacked evaluation, then
        #    finish/refill per trial.  Evaluation consumes no rng and each
        #    trial's clock is private, so the per-trial operation order is
        #    the standalone loop's.
        wall = time.perf_counter() - t0
        share = wall / max(len(lanes), 1)
        applied = []
        with obs.span("APPLY", phase="apply", n_lanes=len(lanes)):
            for ln in lanes:
                tr, fl = ln.tr, ln.fl
                tr.wall += share
                tr.srv.selector.update(int(fl.client_id), ln.loss,
                                       fl.n_examples)
                aggregated, staleness = tr.eng.apply_event(tr.st, fl,
                                                           ln.params)
                applied.append((ln, aggregated, staleness))
        due = [ln.tr for ln, aggregated, _s in applied
               if aggregated and eval_due(len(ln.tr.st.history),
                                          ln.tr.srv.config.eval_every,
                                          ln.tr.srv.config.max_rounds)]
        with obs.span("EVAL", phase="eval", n_due=len(due)):
            accs = evaluate_stacked(
                [(tr.srv.model, tr.srv.dataset, tr.srv.config.eval_points,
                  tr.st.params) for tr in due], pad_pow2=True)
        acc_of = {id(tr): a for tr, a in zip(due, accs)}
        for ln, aggregated, staleness in applied:
            tr = ln.tr
            if aggregated:
                tr.eng.finish_event_round(tr.st, staleness, share,
                                          accuracy=acc_of.get(id(tr)))
                if tr.st.reached:
                    end(tr)
                    continue
            tr.eng.fill_event_concurrency(tr.st, tr.eng.clock.now,
                                          queue=tr.view)
            if len(tr.st.history) >= tr.srv.config.max_rounds:
                end(tr)
        if obs.enabled() and live:
            obs.counter("t_sim", max(tr.eng.clock.now for tr in live))
        return len(lanes)


def run_vectorized_events(specs: Sequence[TrialSpec], *,
                          pack: str = "batched",
                          on_result: Optional[Callable] = None,
                          verbose: bool = False, device=None,
                          init_params: InitFn = None) -> List[TrialResult]:
    """Run T async/buffered trials concurrently off ONE merged event queue
    (``_EventEngine`` macro-steps over the set of unfinished trials).
    Each trial's accuracies, costs, dispatch/staleness logs and (M, E)
    trajectory equal its standalone ``FLServer.run()``."""
    for s in specs:
        if s.mode not in ("async", "buffered"):
            raise ValueError(
                f"trial {s.key()!r} is not an event-driven trial "
                "(run_vectorized_events covers the async/buffered modes; "
                "sync trials pack per round via run_vectorized)")
    _check_pack(pack)
    ev = _EventEngine(device, init_params)
    # trial ordinals from sorted keys: the merged queue's cross-trial tie
    # order is then independent of the caller's spec order
    order = sorted(range(len(specs)), key=lambda i: specs[i].key())
    trials: List[_EventTrial] = [None] * len(specs)
    for i in order:
        trials[i] = ev.admit(specs[i])
    results: List[TrialResult] = [None] * len(specs)
    engine = f"vectorized-events/{pack}"

    def on_done(tr: _EventTrial):
        res = TrialResult.from_flresult(tr.spec, tr.eng.event_result(tr.st),
                                        tr.wall, engine, tr.local_steps)
        results[trials.index(tr)] = res
        if on_result is not None:
            on_result(res)

    while True:
        live = [tr for tr in trials if not tr.done]
        if not live:
            break
        n_lanes = ev.macro_step(live, on_done)
        if verbose and ev.n_steps % 20 == 0:
            done = sum(tr.done for tr in trials)
            print(f"  event sweep step {ev.n_steps}: {done}/{len(trials)}"
                  f" trials done, {n_lanes} arrivals packed", flush=True)
    return results


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def run_vectorized(specs: Sequence[TrialSpec], *, pack: str = "batched",
                   on_result: Optional[Callable[[TrialResult], None]] = None,
                   verbose: bool = False, device=None,
                   init_params: InitFn = None) -> List[TrialResult]:
    """Run every trial concurrently: sync trials through the round-packed
    engine (one cohort per virtual round), async/buffered trials through
    the merged-event-queue engine (one cohort per macro-step).  Results
    come back in input-spec order; ``on_result`` fires per trial as it
    finishes.  Upload-compressed trials pack like any others (the round
    trip is a per-lane transform), so mixed grids pack into one cohort."""
    _check_pack(pack)
    sync_specs = [s for s in specs if s.mode == "sync"]
    event_specs = [s for s in specs if s.mode != "sync"]
    out: Dict[str, TrialResult] = {}

    def keep(res: TrialResult):
        out[res.spec.key()] = res
        if on_result is not None:
            on_result(res)

    kw = dict(on_result=keep, verbose=verbose, device=device,
              init_params=init_params)
    if sync_specs:
        _run_vectorized_sync(sync_specs, **kw)
    if event_specs:
        run_vectorized_events(event_specs, pack=pack, **kw)
    return [out[s.key()] for s in specs]


def run_sweep(specs: Sequence[TrialSpec], *, store=None,
              engine: str = "vectorized", pack: str = "batched",
              verbose: bool = False, device=None,
              init_params: InitFn = None) -> List[TrialResult]:
    """Run a list of trials and (optionally) append each finished trial to
    ``store`` as it completes: the unit of resume is the trial, so a killed
    sweep restarts at the first unfinished key.

    ``engine='vectorized'`` packs every trial (sync trials per virtual
    round, async/buffered trials off the merged event queue);
    ``engine='sequential'`` runs everything one ``FLServer.run()`` at a
    time.  Engines give the same records, so stores can mix them."""
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; valid engines: "
                         + ", ".join(ENGINES))
    results: List[TrialResult] = []

    def emit(res: TrialResult):
        results.append(res)
        if store is not None:
            store.append(res.to_record())

    if engine == "sequential":
        for spec in specs:
            emit(run_trial(spec, device=device, init_params=init_params))
        return results

    if specs:
        run_vectorized(specs, pack=pack, on_result=emit, verbose=verbose,
                       device=device, init_params=init_params)
    return results
