"""FL server: round orchestration, participant selection, cost accounting,
evaluation, and the tuner hook (counterpart of ``repro.federated.server``).

``run()`` hands orchestration to the event-driven runtime (sync / async /
buffered execution over a device fleet); ``run_legacy()`` is the original
synchronous, homogeneous loop that the runtime's sync mode reproduces round
for round.  The server runs on ``device`` (default ``cuda``; raises when no
GPU is present unless ``device="cpu"``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, List, Optional, Tuple

import numpy as np

from repro_torch import perf
from repro_torch.core.costs import CostModel, SystemCost
from repro_torch.core.tuner import HyperParams, Tuner
from repro_torch.data.synthetic import FederatedDataset
from repro_torch.device import resolve_device
from repro_torch.federated.aggregation import Aggregator, ClientUpdate
from repro_torch.federated.client import local_train
from repro_torch.federated.compression import compress_delta, upload_factor
from repro_torch.federated.evaluation import Evaluator, eval_due
from repro_torch.federated.selection import get_selector
from repro_torch.models.registry import Model
from repro_torch.optim.optimizers import Optimizer
from repro_torch.tree import leaves


@dataclass
class FLConfig:
    m: int = 20                    # initial participants per round
    e: float = 20.0                # initial local passes
    batch_size: int = 5
    target_accuracy: float = 0.8
    max_rounds: int = 500
    eval_points: int = 1024
    prox_mu: float = 0.0
    seed: int = 0
    eval_every: int = 1
    log_every: int = 0             # 0 = silent
    selection: str = "random"      # random | guided | smallest | deadline
    compression: Optional[str] = None  # None | "int8" upload deltas


@dataclass
class RoundRecord:
    round_idx: int
    m: int
    e: float
    accuracy: float
    cost: SystemCost
    wall_time: float
    sim_time: float = 0.0          # virtual clock at the end of the round
    n_updates: int = -1            # arrivals aggregated (-1 = legacy loop)


@dataclass
class FLResult:
    reached_target: bool
    rounds: int
    final_accuracy: float
    total_cost: SystemCost
    history: List[RoundRecord]
    final_m: int
    final_e: float
    params: Any = None             # final global model parameters
    sim_time: float = 0.0          # total virtual wall-clock (runtime modes)
    dispatch_log: Optional[List[tuple]] = None   # async/buffered: every
                                   # dispatch as (virtual t, cid, version)
    staleness_log: Optional[List[int]] = None    # async/buffered: staleness
                                   # of each applied (non-dropout) arrival


class FLServer:
    def __init__(self, model: Model, dataset: FederatedDataset,
                 aggregator: Aggregator, optimizer: Optimizer,
                 cost_model: CostModel, config: FLConfig,
                 tuner: Optional[Tuner] = None,
                 fleet=None, runtime_config=None, device=None):
        self.model = model
        self.dataset = dataset
        self.aggregator = aggregator
        self.optimizer = optimizer
        self.cost_model = cost_model
        self.config = config
        self.tuner = tuner or Tuner()
        self.device = resolve_device(device)
        self.rng = np.random.default_rng(config.seed)
        self.evaluator = Evaluator(model, dataset, config.eval_points,
                                   self.device)
        self.fleet = fleet
        self.runtime_config = runtime_config
        est_times = None
        if fleet is not None:
            # deadline-aware selection signal: expected dispatch->arrival
            # time per client (download + E passes of compute + upload)
            c1 = cost_model.train_flops_per_example
            down, up = cost_model.traffic_halves(
                upload_factor(config.compression))
            est_times = np.asarray(fleet.est_round_times(
                np.arange(dataset.n_clients),
                np.asarray(dataset.client_sizes, np.float64),
                config.e, c1, down, up))
        self.selector = get_selector(config.selection, dataset.n_clients,
                                     self.rng,
                                     client_sizes=dataset.client_sizes,
                                     est_times=est_times)

    # ------------------------------------------------------------------
    def _evaluate(self, params) -> float:
        return self.evaluator.evaluate(params)

    def initial_params(self, params=None):
        """``params`` (checked to lie on the server's device), or a fresh
        seed-determined init there."""
        if params is None:
            return self.model.init(self.config.seed, self.device)
        for t in leaves(params):
            if t.device.type != self.device.type:
                raise ValueError(f"params lie on {t.device}, the server runs "
                                 f"on {self.device}")
        return params

    # ------------------------------------------------------------------
    def _client_update(self, params, cid: int, e: float
                       ) -> Tuple[ClientUpdate, int]:
        """Run one client's local training against ``params``.  Shared by
        the legacy loop and the event-driven runtime so both consume the
        server rng stream identically (batch permutations)."""
        cfg = self.config
        x, y = self.dataset.client_data(int(cid))
        with perf.timed("train"):
            upd = local_train(
                self.model, params, x, y, passes=e,
                batch_size=cfg.batch_size, optimizer=self.optimizer,
                rng=self.rng, prox_mu=cfg.prox_mu)
            if cfg.compression:
                upd = upd._replace(params=compress_delta(
                    params, upd.params, cfg.compression))
        upd = upd._replace(client_id=int(cid))
        self.selector.update(int(cid), upd.last_loss, len(y))
        return upd, len(y)

    # ------------------------------------------------------------------
    def run(self, params=None) -> FLResult:
        """Execute FL through the event-driven runtime.  Mode and fleet come
        from ``runtime_config`` / ``fleet`` (defaults: sync execution over a
        homogeneous unit fleet == the legacy loop's behaviour)."""
        from repro_torch.runtime.engine import (EventDrivenRuntime,
                                                RuntimeConfig)
        rt = EventDrivenRuntime(self, fleet=self.fleet,
                                config=self.runtime_config or RuntimeConfig())
        return rt.run(params)

    # ------------------------------------------------------------------
    def run_legacy(self, params=None) -> FLResult:
        """The original synchronous, homogeneous round loop (paper setting).
        Kept as the reference the runtime's sync mode is verified against."""
        cfg = self.config
        params = self.initial_params(params)
        hp = HyperParams(m=cfg.m, e=cfg.e)
        history: List[RoundRecord] = []
        accuracy = 0.0
        reached = False

        for r in range(cfg.max_rounds):
            t0 = time.perf_counter()  # noqa: REPRO004 -- measures the RoundRecord.wall info field only; costs come from the cost model
            m = min(hp.m, self.dataset.n_clients)
            participants = self.selector.select(m)
            updates: List[ClientUpdate] = []
            examples = []
            for cid in participants:
                upd, n = self._client_update(params, int(cid), hp.e)  # noqa: REPRO003 -- a client id from the selector's numpy draw
                updates.append(upd)
                examples.append(n)
            params = self.aggregator(params, updates)
            round_cost = self.cost_model.add_round(
                examples, hp.e,
                upload_factor=upload_factor(cfg.compression))

            if eval_due(r, cfg.eval_every, cfg.max_rounds):
                accuracy = self._evaluate(params)
            wall = time.perf_counter() - t0  # noqa: REPRO004 -- RoundRecord.wall is informational; parity ignores it
            history.append(RoundRecord(r, hp.m, hp.e, accuracy,
                                       round_cost, wall))
            if cfg.log_every and (r + 1) % cfg.log_every == 0:
                print(f"  round {r+1:4d}  acc={accuracy:.4f}  M={hp.m} "
                      f"E={hp.e:g}  wall={wall:.2f}s", flush=True)
            if accuracy >= cfg.target_accuracy:
                reached = True
                break
            hp = self.tuner.on_round(r, accuracy, round_cost,
                                     self.cost_model.total, hp)
            hp = hp.clamped(self.dataset.n_clients, 100.0)

        return FLResult(
            reached_target=reached,
            rounds=len(history),
            final_accuracy=accuracy,
            total_cost=self.cost_model.total.copy(),
            history=history,
            final_m=hp.m,
            final_e=hp.e,
            params=params,
        )
