"""FL training launcher (counterpart of ``repro.launch.train``'s
``simulate`` mode).

The paper's experiment: host-level FL over the synthetic federated datasets
with FedTune, on the device named by ``--device`` (default ``cuda``; a
machine without a GPU needs ``--device cpu``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --dataset emnist \
      --preference 0.25,0.25,0.25,0.25 --rounds 100 [--fedtune]
  PYTHONPATH=src python -m repro_torch.launch.train --runtime buffered \
      --het stragglers --buffer-k 8 --fedtune

The flags are the reference's.  ``--mode mesh``, ``--trace``/``--trace-jax``
and ``--checkpoint`` raise ``NotImplementedError`` until the multi-GPU,
tracing and checkpoint slices land (see ROADMAP.md), and so does the
``sharded`` client-execution backend; ``--client-exec batched`` trains a
sync round's clients as one packed cohort.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=("simulate", "mesh"), default="simulate")
    ap.add_argument("--dataset", default="emnist",
                    choices=("speech_command", "emnist", "cifar100"))
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--preference", default="0.25,0.25,0.25,0.25")
    ap.add_argument("--rounds", type=int, default=100)
    ap.add_argument("--target", type=float, default=0.5)
    ap.add_argument("--m", type=int, default=5)
    ap.add_argument("--e", type=float, default=2.0)
    ap.add_argument("--aggregator", default="fedavg")
    ap.add_argument("--fedtune", action="store_true")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--runtime", choices=("sync", "async", "buffered"),
                    default="sync")
    ap.add_argument("--het", default="homogeneous",
                    help="heterogeneity profile (homogeneous | mild | "
                         "stragglers | mobile)")
    ap.add_argument("--selection", default="random",
                    choices=("random", "guided", "smallest", "deadline"))
    ap.add_argument("--deadline-quantile", type=float, default=1.0,
                    help="sync: cut stragglers above this completion "
                         "quantile")
    ap.add_argument("--buffer-k", type=int, default=8,
                    help="buffered: updates aggregated per flush")
    ap.add_argument("--staleness-alpha", type=float, default=0.5)
    ap.add_argument("--batched", action="store_true",
                    help="deprecated alias for --client-exec batched")
    ap.add_argument("--client-exec", default=None,
                    choices=("sequential", "batched", "sharded"),
                    help="sync-mode client execution backend (sharded "
                         "is not ported)")
    ap.add_argument("--trace", nargs="?", const="runs/train.trace.json",
                    default=None, metavar="PATH",
                    help="dual-clock trace of the run (not ported yet)")
    ap.add_argument("--trace-jax", action="store_true",
                    help="with --trace: profiler annotations (not ported)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on: cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.mode == "mesh":
        raise NotImplementedError(
            "--mode mesh is not ported yet: it comes with the multi-GPU "
            "slice (see ROADMAP.md)")
    if args.trace is not None or args.trace_jax:
        raise NotImplementedError(
            "--trace is not ported yet: it comes with the observability "
            "slice (see ROADMAP.md)")
    if args.checkpoint:
        raise NotImplementedError(
            "--checkpoint is not ported yet: it comes with the serving/"
            "checkpoint slice (see ROADMAP.md)")

    import numpy as np

    from repro_torch.configs.paper_models import MLPConfig
    from repro_torch.core import CostModel, FedTune, FedTuneConfig, Preference
    from repro_torch.core.tuner import HyperParams
    from repro_torch.data import (cifar100_like, emnist_like,
                                  speech_command_like)
    from repro_torch.device import resolve_device
    from repro_torch.federated import FLConfig, FLServer, get_aggregator
    from repro_torch.models import build_model
    from repro_torch.optim.optimizers import get_optimizer
    from repro_torch.runtime import RuntimeConfig, sample_fleet
    from repro_torch.tree import leaves

    device = resolve_device(args.device)
    ds_fns = {"speech_command": speech_command_like, "emnist": emnist_like,
              "cifar100": cifar100_like}
    dataset = ds_fns[args.dataset](reduced=not args.full)
    in_dim = int(np.prod(dataset.spec.shape))
    model = build_model(MLPConfig(name="mlp", in_dim=in_dim, hidden=(48,),
                                  n_classes=dataset.spec.n_classes))
    n_params = sum(p.numel() for p in leaves(model.init(0, device)))

    a, b, g, d = (float(x) for x in args.preference.split(","))
    pref = Preference(a, b, g, d)
    tuner = (FedTune(FedTuneConfig(preference=pref),
                     HyperParams(args.m, args.e)) if args.fedtune else None)
    fleet = (None if args.het == "homogeneous"
             else sample_fleet(args.het, dataset.n_clients, seed=0))
    rtcfg = RuntimeConfig(
        mode=args.runtime, deadline_quantile=args.deadline_quantile,
        buffer_k=args.buffer_k, staleness_alpha=args.staleness_alpha,
        client_exec=args.client_exec or
        ("batched" if args.batched else "sequential"))
    server = FLServer(
        model, dataset, get_aggregator(args.aggregator),
        get_optimizer("sgd", 0.03, momentum=0.9),
        CostModel(flops_per_example=2 * n_params, param_count=n_params),
        FLConfig(m=args.m, e=args.e, batch_size=10,
                 target_accuracy=args.target, max_rounds=args.rounds,
                 log_every=max(args.rounds // 20, 1),
                 selection=args.selection),
        tuner=tuner, fleet=fleet, runtime_config=rtcfg, device=device)
    res = server.run()
    c = res.total_cost
    print(f"\ndone: rounds={res.rounds} acc={res.final_accuracy:.3f} "
          f"M={res.final_m} E={res.final_e:g} t_sim={res.sim_time:.4g} "
          f"device={device}")
    print(f"CompT={c.comp_t:.4g} TransT={c.trans_t:.4g} "
          f"CompL={c.comp_l:.4g} TransL={c.trans_l:.4g}")
    return res


if __name__ == "__main__":
    main()
