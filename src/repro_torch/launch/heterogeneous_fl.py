"""FedTune under stragglers: tuning (M, E) in all three runtime modes
(counterpart of ``examples/heterogeneous_fl.py``).

The paper tunes (M, E) against the four system overheads assuming
homogeneous, fully synchronous clients.  This demo runs the same FedTune
controller on a *straggler* fleet (15% of devices are 10x slower, 5%
drop out mid-round) in each execution mode of the event-driven runtime:

  sync      — classic deadline rounds; stragglers above the 0.7 completion
              quantile are cut.
  async     — FedAsync: staleness-discounted immediate application
              (the fed_aggregate kernel).
  buffered  — FedBuff: K staleness-weighted deltas per aggregation through
              the fed_reduce kernel.

For each mode it reports the accuracy reached, the virtual wall-clock, the
four overheads, and where FedTune drove (M, E).  It runs on ``--device``
(default ``cuda``; a machine without a GPU needs ``--device cpu``).

Usage: PYTHONPATH=src python -m repro_torch.launch.heterogeneous_fl [--rounds N]

The flags are the example's, plus ``--device``.  ``--client-exec sharded``
shards the sync mode's cohort over the ranks that ``torchrun`` starts
(``launch/train.py``); only rank 0 prints, and a single process prints
the fallback and runs batched:

  torchrun --nproc-per-node 2 -m repro_torch.launch.heterogeneous_fl \\
      --client-exec sharded
"""

from __future__ import annotations

import argparse

from repro_torch.configs.paper_models import MLPConfig
from repro_torch.core import CostModel, FedTune, FedTuneConfig, Preference
from repro_torch.core.tuner import HyperParams
from repro_torch.data import emnist_like
from repro_torch.device import resolve_device
from repro_torch.federated import FLConfig, FLServer, get_aggregator
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import build_model
from repro_torch.optim.optimizers import get_optimizer
from repro_torch.runtime import RuntimeConfig, sample_fleet
from repro_torch.tree import leaves
from repro_torch.weights import params_from_numpy


def run_mode(name: str, rt: RuntimeConfig, *, rounds: int, m0: int,
             e0: float, pref: Preference, het: str = "stragglers",
             device="cuda", init_params=None):
    """One FedTune run in runtime mode ``rt``; ``init_params`` (a numpy
    tree) starts it from those params (the port's seeded init without
    it)."""
    device = resolve_device(device)
    dataset = emnist_like(reduced=True)
    model = build_model(MLPConfig(name="mlp", in_dim=28 * 28, hidden=(48,),
                                  n_classes=dataset.spec.n_classes))
    n_params = sum(p.numel() for p in leaves(model.init(0, device)))
    fleet = sample_fleet(het, dataset.n_clients, seed=0)
    tuner = FedTune(FedTuneConfig(preference=pref), HyperParams(m0, e0))
    server = FLServer(
        model, dataset, get_aggregator("fedavg"),
        get_optimizer("sgd", 0.03, momentum=0.9),
        CostModel(flops_per_example=2 * n_params, param_count=n_params),
        FLConfig(m=m0, e=e0, batch_size=10, target_accuracy=0.6,
                 max_rounds=rounds, eval_points=512),
        tuner=tuner, fleet=fleet, runtime_config=rt, device=device)
    res = server.run(None if init_params is None
                     else params_from_numpy(init_params, device))
    if mesh_mod.is_writer():
        c = res.total_cost
        arrived = [h.n_updates for h in res.history[:5]]
        print(f"{name:10s} acc={res.final_accuracy:.3f} aggs={res.rounds:3d} "
              f"t_sim={res.sim_time:9.3g}  M:{m0}->{res.final_m} "
              f"E:{e0:g}->{res.final_e:g}")
        print(f"{'':10s} CompT={c.comp_t:.3g} TransT={c.trans_t:.3g} "
              f"CompL={c.comp_l:.3g} TransL={c.trans_l:.3g} "
              f"first-rounds arrivals={arrived}")
    return res


def main(argv=None, init_params=None):
    """Runs the three modes and returns ``{mode: FLResult}``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--m", type=int, default=8)
    ap.add_argument("--e", type=float, default=1.0)
    ap.add_argument("--het", default="stragglers")
    ap.add_argument("--preference", default="0.5,0.0,0.5,0.0",
                    help="alpha,beta,gamma,delta (CompT+CompL default: "
                         "straggler-sensitive)")
    ap.add_argument("--client-exec", default="sequential",
                    choices=("sequential", "batched", "sharded"),
                    help="sync-mode client execution backend (sharded: "
                         "over the ranks torchrun starts)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on: cuda (default) or cpu")
    args = ap.parse_args(argv)
    pref = Preference(*(float(x) for x in args.preference.split(",")))

    device = resolve_device(args.device)
    mesh = (mesh_mod.init_from_env(device)
            if args.client_exec == "sharded" else None)
    if mesh is not None:
        device = mesh.device
    if mesh_mod.is_writer():
        print(f"FedTune over a '{args.het}' fleet, preference "
              f"{tuple(pref.as_tuple())}\n")
    kw = dict(rounds=args.rounds, m0=args.m, e0=args.e, pref=pref,
              het=args.het, device=device, init_params=init_params)
    runs = {
        "sync": run_mode("sync", RuntimeConfig(
            mode="sync", deadline_quantile=0.7,
            client_exec=args.client_exec), **kw),
        "async": run_mode("async", RuntimeConfig(mode="async"), **kw),
        "buffered": run_mode("buffered", RuntimeConfig(
            mode="buffered", buffer_k=max(args.m // 2, 1)), **kw)}
    if mesh is not None:
        mesh_mod.leave()         # the collectives are over
    return runs


if __name__ == "__main__":
    main()
