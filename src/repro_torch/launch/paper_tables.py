"""Reduced-dataset versions of the paper's Tables 4/5/6 through the port's
sweep engine (counterpart of ``examples/paper_tables.py``).

The paper's headline numbers are grids: FedTune vs a FixedTuner baseline
across 15 preference vectors (Table 4), three datasets (Table 5), and five
aggregation methods (Table 6).  This launcher expands the corresponding
(reduced-scale) grids, runs every trial concurrently through the
vectorized trials-as-an-axis engine on ``--device`` (default ``cuda``; a
machine without a GPU needs ``--device cpu``), and prints the paper-style
mean +- std overhead-reduction tables.  Results land in a JSONL store whose
keys and records are the reference's, so a re-run (of either package)
only computes what is missing: bump ``--seeds`` and re-invoke to tighten
the error bars without redoing finished trials.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.paper_tables       # Table 4 (subset)
  PYTHONPATH=src python -m repro_torch.launch.paper_tables --table 5
  PYTHONPATH=src python -m repro_torch.launch.paper_tables --table 6 --seeds 3
  PYTHONPATH=src python -m repro_torch.launch.paper_tables --prefs all --rounds 30

The flags are the example's, plus ``--device``.  ``--pack sharded`` lays
each packed round's FedAvg trials over the ranks that ``torchrun`` starts
(``launch/sweep.py``); a single process prints the fallback and runs the
batched pack.
"""

from __future__ import annotations

import argparse
import time

from repro_torch.device import resolve_device
from repro_torch.experiments import (ResultStore, SweepSpec, TrialSpec,
                                     paper_table, parse_preferences,
                                     run_sweep)
from repro_torch.launch import mesh as mesh_mod


def build_sweep(table: int, prefs: str, seeds: int, rounds: int,
                target: float) -> SweepSpec:
    base = TrialSpec(rounds=rounds, target_accuracy=target, batch_size=10,
                     eval_points=512)
    seed_axis = tuple(range(seeds))
    if table == 4:      # preferences x FedAvg on speech-command-like
        return SweepSpec(datasets=("speech_command",),
                         aggregators=("fedavg",),
                         preferences=parse_preferences(prefs),
                         seeds=seed_axis, base=base)
    if table == 5:      # datasets under the balanced preference
        return SweepSpec(datasets=("speech_command", "emnist", "cifar100"),
                         aggregators=("fedavg",),
                         preferences=parse_preferences("14"),
                         seeds=seed_axis, base=base)
    if table == 6:      # aggregation methods on speech-command-like
        return SweepSpec(datasets=("speech_command",),
                         aggregators=("fedavg", "fednova", "fedadagrad",
                                      "fedadam", "fedyogi"),
                         preferences=parse_preferences("14"),
                         seeds=seed_axis, base=base)
    raise ValueError(f"unknown table {table}; valid tables: 4, 5, 6")


def main(argv=None, init_params=None):
    """Runs the table's pending trials and prints it; returns the results
    of the trials it ran.  ``init_params(spec) -> numpy tree`` gives each
    trial its initial params (``run_sweep``'s hook; the port's seeded
    init without it)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--table", type=int, default=4, choices=(4, 5, 6))
    ap.add_argument("--prefs", default="0,1,4,14",
                    help="Table 4 preference axis: 'all', paper indices, "
                         "or ';'-separated quads")
    ap.add_argument("--seeds", type=int, default=1)
    ap.add_argument("--rounds", type=int, default=15)
    ap.add_argument("--target", type=float, default=0.5)
    ap.add_argument("--out", default="runs/paper_tables.jsonl")
    ap.add_argument("--pack", default="batched",
                    choices=("batched", "sharded"))
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on: cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    mesh = mesh_mod.init_from_env(device) if args.pack == "sharded" else None
    if mesh is not None:
        device = mesh.device
    writer = mesh_mod.is_writer()
    sweep = build_sweep(args.table, args.prefs, args.seeds, args.rounds,
                        args.target)
    specs = sweep.expand()
    store = ResultStore(args.out)
    if mesh is not None:
        mesh.barrier()         # every rank reads the store rank 0 left...
    done = store.completed_keys()
    pending = [s for s in specs if s.key() not in done]
    if mesh is not None:
        mesh.barrier()         # ...before rank 0 appends to it
    if writer:
        print(f"table {args.table}: {len(specs)} trials "
              f"({len(specs) - len(pending)} already done)", flush=True)
    t0 = time.perf_counter()
    results = run_sweep(pending, store=store, engine="vectorized",
                        pack=args.pack, device=device,
                        init_params=init_params)
    if mesh is not None:
        mesh_mod.leave()         # the collectives are over
    if writer:
        print(f"ran {len(pending)} trial(s) in "
              f"{time.perf_counter() - t0:.1f}s\n")
        print(paper_table(store.load(),
                          title=f"Paper Table {args.table} "
                                "(reduced-scale reproduction)"))
    return results


if __name__ == "__main__":
    main()
