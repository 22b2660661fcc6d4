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

The flags are the reference's, plus ``--device``.  ``--checkpoint PATH``
saves the final params (``repro_torch.checkpoint.save_checkpoint``: a file
the reference's ``load_checkpoint`` reads too); ``--trace`` writes a
dual-clock Chrome trace and a metrics JSONL, and ``--trace-jax`` adds an
NVTX range per span (the reference's flag, whose JAX trace annotations
become NVTX ranges here).  ``--client-exec batched`` trains a sync round's
clients as one packed cohort; ``--client-exec sharded`` shards it over the
ranks that ``torchrun`` starts, each on its own device (``nccl`` when
every rank has a card, ``gloo`` when ranks share one or run on the CPU;
``launch/mesh.py``), and only rank 0 prints and writes:

  torchrun --nproc-per-node 2 -m repro_torch.launch.train \
      --client-exec sharded --fedtune

A single process falls back to ``batched``, as the reference does on one
device.  ``--mode mesh`` (the LM half of the multi-GPU slice, ROADMAP.md
queue 1, item 15b) raises ``NotImplementedError``.
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
                    help="sync-mode client execution backend (sharded: "
                         "over the ranks torchrun starts)")
    ap.add_argument("--trace", nargs="?", const="runs/train.trace.json",
                    default=None, metavar="PATH",
                    help="record a dual-clock trace of the run: Chrome "
                         "trace-event JSON (open in Perfetto) plus a "
                         "metrics JSONL beside it")
    ap.add_argument("--trace-jax", action="store_true",
                    help="with --trace: also open an NVTX range per span, "
                         "so a device profile lines up with the spans")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on: cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.mode == "mesh":
        raise NotImplementedError(
            "--mode mesh is not ported yet: it comes with the LM half of the "
            "multi-GPU slice (ROADMAP.md queue 1, item 15b)")

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

    from repro_torch.launch import mesh as mesh_mod

    device = resolve_device(args.device)
    mesh = (mesh_mod.init_from_env(device)
            if args.client_exec == "sharded" else None)
    if mesh is not None:
        device = mesh.device
    writer = mesh_mod.is_writer()
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
                 log_every=max(args.rounds // 20, 1) if writer else 0,
                 selection=args.selection),
        tuner=tuner, fleet=fleet, runtime_config=rtcfg, device=device)
    if args.trace is not None and writer:
        from repro_torch import obs
        obs.enable(nvtx=args.trace_jax)
    res = server.run()
    if mesh is not None:
        mesh_mod.leave()         # the collectives are over
    if not writer:
        return res
    if args.trace is not None:
        from repro_torch import obs
        from repro_torch.obs.export import (trace_paths_for,
                                            write_chrome_trace,
                                            write_metrics_jsonl)
        obs.disable()
        trace_path, metrics_path = trace_paths_for("", args.trace)
        write_chrome_trace(trace_path)
        write_metrics_jsonl(metrics_path)
        print(f"trace -> {trace_path}; metrics -> {metrics_path} — open "
              "the trace at https://ui.perfetto.dev", flush=True)
    c = res.total_cost
    print(f"\ndone: rounds={res.rounds} acc={res.final_accuracy:.3f} "
          f"M={res.final_m} E={res.final_e:g} t_sim={res.sim_time:.4g} "
          f"device={device}")
    print(f"CompT={c.comp_t:.4g} TransT={c.trans_t:.4g} "
          f"CompL={c.comp_l:.4g} TransL={c.trans_l:.4g}")
    if args.checkpoint:
        from repro_torch.checkpoint import save_checkpoint
        # the final params with the run's scalar summary as metadata
        save_checkpoint(args.checkpoint, res.params, step=res.rounds,
                        metadata={
                            "final_accuracy": res.final_accuracy,
                            "costs": list(c.as_tuple()),
                            "runtime": args.runtime,
                            "het": args.het,
                            "sim_time": res.sim_time,
                        })
        print(f"checkpoint written to {args.checkpoint}")
    return res


if __name__ == "__main__":
    main()
