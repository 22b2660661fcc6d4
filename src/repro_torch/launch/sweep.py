"""Sweep launcher: run whole grids of FedTune trials as one workload
(counterpart of ``repro.launch.sweep``).

Expands a product grid (datasets x aggregators x preferences x seeds x
(M0,E0) x tuners x runtime modes x fleet profiles x compression), skips
every trial already present in the JSONL result store (resume by trial key:
kill the process and re-invoke to continue), and runs the rest through the
vectorized trials-as-an-axis engine (``repro_torch.experiments.runner``) or
one at a time, on ``--device`` (default ``cuda``; a machine without a GPU
needs ``--device cpu``).  The store's records and keys are the reference's,
so a store written by either package resumes in the other.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.sweep \
      --datasets emnist --aggregators fedavg,fedadam \
      --preferences 0,4,14 --seeds 2 --rounds 20 \
      --out runs/sweep.jsonl --table

  # the smoke grid: 24 reduced trials; --limit N runs only the first N
  # pending trials (the second invocation resumes the remainder)
  PYTHONPATH=src python -m repro_torch.launch.sweep --preset smoke \
      --device cpu --limit 8 --out runs/s.jsonl
  PYTHONPATH=src python -m repro_torch.launch.sweep --preset smoke \
      --device cpu --table --out runs/s.jsonl

The flags are the reference's, plus ``--device``.  ``--trace`` writes a
dual-clock Chrome trace and a metrics JSONL beside the store
(``--trace-jax`` adds an NVTX range per span).  ``--pack sharded`` lays
each packed round's FedAvg trials over the ranks that ``torchrun``
starts, each on its own device (``nccl`` when every rank has a card,
``gloo`` when ranks share one or run on the CPU; ``launch/mesh.py``);
only rank 0 prints and writes the store, and a single process falls back
to the batched pack:

  torchrun --nproc-per-node 2 -m repro_torch.launch.sweep --preset smoke \
      --pack sharded --out runs/s.jsonl
"""

from __future__ import annotations

import argparse
import time


def smoke_grid():
    """The smoke grid: 24 tiny reduced-dataset trials (18 fedtune + 6
    shared fixed baselines)."""
    from repro_torch.experiments import SweepSpec, TrialSpec, parse_preferences
    return SweepSpec(
        datasets=("emnist",),
        aggregators=("fedavg", "fednova", "fedadam"),
        preferences=parse_preferences("0,3,14"),
        seeds=(0, 1),
        inits=((4, 1.0),),
        base=TrialSpec(rounds=3, target_accuracy=0.99, batch_size=5,
                       eval_points=128),
    )


def smoke_async_grid():
    """The event-runtime smoke grid: 8 tiny trials spanning the async and
    buffered runtime modes (fedtune + fixed baselines per mode), all
    vectorized off the merged event queue."""
    from repro_torch.experiments import SweepSpec, TrialSpec, parse_preferences
    return SweepSpec(
        datasets=("emnist",),
        aggregators=("fedavg",),
        preferences=parse_preferences("14"),
        seeds=(0, 1),
        inits=((4, 1.0),),
        modes=("async", "buffered"),
        base=TrialSpec(rounds=2, target_accuracy=0.99, batch_size=5,
                       eval_points=128),
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--datasets", default="emnist",
                    help="comma list: speech_command,emnist,cifar100")
    ap.add_argument("--aggregators", default="fedavg",
                    help="comma list, e.g. fedavg,fednova,fedadam")
    ap.add_argument("--preferences", default="14",
                    help="'all', paper indices '0,4,14', or quads "
                         "'1,0,0,0;0.25,0.25,0.25,0.25'")
    ap.add_argument("--seeds", type=int, default=1,
                    help="number of seeds (0..N-1)")
    ap.add_argument("--seed-base", type=int, default=0)
    ap.add_argument("--tuners", default="fedtune,fixed")
    ap.add_argument("--init", default="5:2.0",
                    help="(M0,E0) axis as colon pairs: '5:2.0;10:1.0'")
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--target", type=float, default=0.5)
    ap.add_argument("--batch-size", type=int, default=10)
    ap.add_argument("--mode", default="sync",
                    help="comma list of runtime modes (grid axis): "
                         "sync,async,buffered")
    ap.add_argument("--het", default="homogeneous",
                    help="comma list of fleet profiles (grid axis): "
                         "homogeneous,mild,stragglers,mobile")
    ap.add_argument("--compression", default="none",
                    help="comma list of upload-compression methods (grid "
                         "axis): none,int8")
    ap.add_argument("--full", action="store_true",
                    help="paper-scale datasets (default: reduced)")
    ap.add_argument("--engine", default="vectorized",
                    choices=("vectorized", "sequential"))
    ap.add_argument("--pack", default="batched",
                    choices=("batched", "sharded"),
                    help="vectorized cohort packing (sharded: over the "
                         "ranks torchrun starts)")
    ap.add_argument("--out", default="runs/sweep.jsonl",
                    help="JSONL result store (resume key source)")
    ap.add_argument("--no-resume", action="store_true",
                    help="truncate the store instead of skipping "
                         "completed trial keys")
    ap.add_argument("--limit", type=int, default=0,
                    help="run at most N pending trials (0 = all)")
    ap.add_argument("--table", action="store_true",
                    help="emit the paper-style overhead-reduction table")
    ap.add_argument("--preset", default=None,
                    choices=("smoke", "smoke-async"),
                    help="named grid (smoke = the 24-trial grid; "
                         "smoke-async = the 8-trial async/buffered grid)")
    ap.add_argument("--trace", nargs="?", const="auto", default=None,
                    metavar="PATH",
                    help="record a dual-clock trace (Chrome trace-event "
                         "JSON + metrics JSONL, paths derived from --out "
                         "unless PATH is given); parity-neutral")
    ap.add_argument("--trace-jax", action="store_true",
                    help="with --trace: also open an NVTX range per span, "
                         "so a device profile lines up with the spans")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on: cuda (default) or cpu")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)

    from repro_torch.device import resolve_device
    from repro_torch.experiments import (ResultStore, SweepSpec, TrialSpec,
                                         paper_table, parse_preferences,
                                         run_sweep)

    from repro_torch.launch import mesh as mesh_mod

    device = resolve_device(args.device)
    mesh = mesh_mod.init_from_env(device) if args.pack == "sharded" else None
    if mesh is not None:
        device = mesh.device
    writer = mesh_mod.is_writer()
    say = print if writer else (lambda *a, **k: None)
    if args.preset == "smoke":
        sweep = smoke_grid()
    elif args.preset == "smoke-async":
        sweep = smoke_async_grid()
    else:
        inits = []
        for pair in args.init.split(";"):
            m0, e0 = pair.split(":")
            inits.append((int(m0), float(e0)))
        sweep = SweepSpec(
            datasets=tuple(args.datasets.split(",")),
            aggregators=tuple(args.aggregators.split(",")),
            preferences=parse_preferences(args.preferences),
            seeds=tuple(range(args.seed_base, args.seed_base + args.seeds)),
            tuners=tuple(args.tuners.split(",")),
            inits=tuple(inits),
            modes=tuple(args.mode.split(",")),
            hets=tuple(args.het.split(",")),
            compressions=tuple(
                None if c in ("", "none") else c
                for c in args.compression.split(",")),
            base=TrialSpec(rounds=args.rounds, target_accuracy=args.target,
                           batch_size=args.batch_size,
                           reduced=not args.full),
        )
    specs = sweep.expand()     # validates every axis value eagerly

    store = ResultStore(args.out)
    if args.no_resume and writer:
        store.clear()
    if mesh is not None:
        mesh.barrier()         # every rank reads the store rank 0 left...
    done = store.completed_keys()
    pending = [s for s in specs if s.key() not in done]
    if mesh is not None:
        mesh.barrier()         # ...before rank 0 appends to it
    skipped = len(specs) - len(pending)
    say(f"sweep: {len(specs)} trials in grid; resume: skipping {skipped} "
        f"completed, {len(pending)} pending", flush=True)
    if args.limit > 0:
        pending = pending[:args.limit]
        say(f"sweep: --limit {args.limit} -> running {len(pending)} "
            "trial(s) this invocation", flush=True)

    if args.trace is not None and writer:
        from repro_torch import obs
        obs.enable(nvtx=args.trace_jax)

    t0 = time.perf_counter()
    results = run_sweep(pending, store=store, engine=args.engine,
                        pack=args.pack, verbose=args.verbose, device=device)
    wall = time.perf_counter() - t0
    if mesh is not None:
        mesh_mod.leave()       # the collectives are over
    if not writer:
        return results
    for res in results:
        print(f"  done {res.spec.key()}  acc={res.final_accuracy:.3f} "
              f"rounds={res.rounds} M={res.final_m} E={res.final_e:g}",
              flush=True)
    print(f"sweep: ran {len(results)} trial(s) in {wall:.1f}s "
          f"({args.engine} engine, device={device}); store={args.out}",
          flush=True)

    if args.trace is not None:
        from repro_torch import obs
        from repro_torch.obs.export import (trace_paths_for,
                                            write_chrome_trace,
                                            write_metrics_jsonl)
        obs.disable()
        trace_path, metrics_path = trace_paths_for(
            args.out, None if args.trace == "auto" else args.trace)
        write_chrome_trace(trace_path)
        n_rows = write_metrics_jsonl(metrics_path)
        print(f"sweep: trace -> {trace_path} ({len(obs.tracer.spans)} "
              f"spans); metrics -> {metrics_path} ({n_rows} rows) — open "
              "the trace at https://ui.perfetto.dev", flush=True)

    if args.table:
        print()
        print(paper_table(store.load(),
                          title="FedTune sweep (reduced-scale reproduction)"))
    return results


if __name__ == "__main__":
    main()
