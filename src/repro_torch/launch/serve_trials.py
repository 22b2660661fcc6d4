"""Trial-serving daemon: drain an open-ended queue of tuning trials at
sustained lane occupancy (continuous batching over the sweep engines;
counterpart of ``repro.launch.serve_trials``).

Where ``repro_torch.launch.sweep`` packs a FIXED grid and lets lanes idle
as trials finish, this launcher runs the continuous-batching scheduler
(``repro_torch.experiments.scheduler``): a ``LanePool`` of
``--max-lanes`` lanes, a ``TrialQueue`` seeded from a grid/preset and/or
fed live from a watched JSONL submissions file, retiring each lane the
moment its trial reaches target and admitting the next queued trial into
the freed slot mid-flight.  Every result keeps the (M, E) trajectory, costs and logs of
an independent ``FLServer.run()`` (see the scheduler's parity contract)
and streams to the JSONL result store as it retires, so a killed daemon
resumes past completed keys.  Trials run on ``--device`` (default
``cuda``; a machine without a GPU needs ``--device cpu``).  The flags are
the reference's, plus ``--device``; ``--pack sharded`` raises until the
multi-GPU slice (ROADMAP.md queue 1, item 15).

Usage:
  # write the 12-trial smoke queue into a submissions file (the submit side)
  PYTHONPATH=src python -m repro_torch.launch.serve_trials \
      --preset serve-smoke --submit serve_subs.jsonl

  # drain it with 4 lanes; kill mid-drain with --limit, re-invoke to resume
  PYTHONPATH=src python -m repro_torch.launch.serve_trials \
      --watch serve_subs.jsonl --max-lanes 4 --limit 6 --out runs/serve.jsonl \
      --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve_trials \
      --watch serve_subs.jsonl --max-lanes 4 --out runs/serve.jsonl --trace \
      --device cpu

  # daemon mode: keep polling the submissions file after the queue drains
  # (any writer may append spec lines at any time); Ctrl-C to stop
  PYTHONPATH=src python -m repro_torch.launch.serve_trials \
      --watch serve_subs.jsonl --daemon --max-lanes 8 --out runs/serve.jsonl

A submissions line is a ``TrialSpec.to_dict()`` JSON object (or any record
with a ``"spec"`` field — result-store rows can be piped back in);
malformed lines are skipped with a warning, half-written tails are retried
on the next poll.
"""

from __future__ import annotations

import argparse
import json
import time


def serve_smoke_specs(failure_rate: float = 0.0, churn: str | None = None):
    """The CI serve-smoke queue: 12 tiny trials whose round budgets are
    staggered (1..3) across sync, async, and buffered modes, so lanes
    retire at different times — exactly the drain shape continuous
    batching exists for (a fixed pack would idle up to 2/3 of its lanes
    by the last round).  ``failure_rate``/``churn`` perturb every trial
    with the fleet fault model (the chaos-smoke CI job serves the same
    queue at 10% failures with churn)."""
    from repro_torch.experiments import TrialSpec
    specs = []
    for i in range(6):
        specs.append(TrialSpec(
            dataset="emnist", aggregator="fedavg", seed=i, tuner="fedtune",
            m0=3, e0=1.0, rounds=1 + i % 3, target_accuracy=0.99,
            batch_size=5, eval_points=128, mode="sync",
            failure_rate=failure_rate, churn=churn))
    for i in range(6):
        specs.append(TrialSpec(
            dataset="emnist", aggregator="fedavg", seed=i, tuner="fedtune",
            m0=3, e0=1.0, rounds=1 + i % 3, target_accuracy=0.99,
            batch_size=5, eval_points=128,
            mode="async" if i % 2 == 0 else "buffered",
            failure_rate=failure_rate, churn=churn))
    return specs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default=None, choices=("serve-smoke",),
                    help="named queue (serve-smoke = 12 staggered-budget "
                         "trials across sync/async/buffered)")
    ap.add_argument("--watch", default=None, metavar="PATH",
                    help="JSONL submissions file to poll for new trials "
                         "(one spec object per line, append-only)")
    ap.add_argument("--submit", default=None, metavar="PATH",
                    help="write the preset/grid specs as submission lines "
                         "to PATH and exit (the producer side of --watch)")
    ap.add_argument("--max-lanes", type=int, default=4,
                    help="lane pool capacity (concurrently live trials)")
    ap.add_argument("--pack", default="batched",
                    choices=("batched", "sharded"),
                    help="sync cohort packing (event trials pack batched; "
                         "sharded is not ported)")
    ap.add_argument("--out", default="runs/serve.jsonl",
                    help="JSONL result store (resume key source)")
    ap.add_argument("--no-resume", action="store_true",
                    help="truncate the store instead of skipping "
                         "completed trial keys")
    ap.add_argument("--limit", type=int, default=0,
                    help="stop draining once N trials have retired this "
                         "invocation (0 = drain fully; the crossing step "
                         "may retire a few extra) — simulates a killed "
                         "daemon")
    ap.add_argument("--daemon", action="store_true",
                    help="after draining, keep polling --watch for new "
                         "submissions instead of exiting")
    ap.add_argument("--poll-seconds", type=float, default=1.0,
                    help="daemon-mode sleep between idle polls")
    ap.add_argument("--trace", nargs="?", const="auto", default=None,
                    metavar="PATH",
                    help="record a dual-clock trace (Chrome trace-event "
                         "JSON + metrics JSONL, paths derived from --out) "
                         "— shows the admit/retire drain and the "
                         "pool_occupancy gauge; parity-neutral")
    ap.add_argument("--failure-rate", type=float, default=0.0,
                    metavar="P",
                    help="per-dispatch hard-failure hazard applied to "
                         "preset specs (coordinator retries/reassigns; "
                         "0 = fault-free)")
    ap.add_argument("--churn", default=None, metavar="SPEC",
                    help="fleet churn schedule 'period:rate[:min_active]' "
                         "applied to preset specs")
    ap.add_argument("--snapshot", nargs="?", const="auto", default=None,
                    metavar="PATH",
                    help="arm crash-safe boundary snapshots (two-slot, "
                         "torn-write tolerant; PATH defaults to "
                         "<out>.snap).  If a valid snapshot exists the "
                         "daemon RESUMES from it, replaying at most one "
                         "macro-step with duplicate store rows suppressed")
    ap.add_argument("--snapshot-every", type=int, default=1, metavar="N",
                    help="snapshot every N macro-steps (1 = every step)")
    ap.add_argument("--kill-after-steps", type=int, default=0, metavar="K",
                    help="exit abruptly (code 3, NO final snapshot) after "
                         "K macro-steps — the chaos-smoke crash injector")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on: cuda (default) or cpu")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)

    from repro_torch.device import resolve_device
    from repro_torch.experiments import ResultStore
    from repro_torch.experiments.runner import _check_pack
    from repro_torch.experiments.scheduler import TrialQueue, TrialScheduler

    specs = (serve_smoke_specs(args.failure_rate, args.churn)
             if args.preset == "serve-smoke" else [])
    if not specs and not args.watch:
        ap.error("nothing to serve: give --preset and/or --watch "
                 "(or --submit to produce a submissions file)")

    if args.submit:
        with open(args.submit, "a") as f:
            for s in specs:
                f.write(json.dumps({"spec": s.to_dict()}) + "\n")
        print(f"serve: submitted {len(specs)} spec(s) -> {args.submit}",
              flush=True)
        return

    _check_pack(args.pack)
    device = resolve_device(args.device)
    store = ResultStore(args.out)
    if args.no_resume:
        store.clear()
    snap_path = None
    if args.snapshot is not None:
        snap_path = (args.out + ".snap" if args.snapshot == "auto"
                     else args.snapshot)

    if args.trace is not None:
        from repro_torch import obs
        obs.enable()

    sched = None
    if snap_path is not None and not args.no_resume:
        try:
            sched = TrialScheduler.restore(
                snap_path, store=store, pack=args.pack,
                watch_path=args.watch, verbose=args.verbose,
                snapshot_every=args.snapshot_every, device=device)
        except FileNotFoundError:
            pass           # no valid slot yet: cold start below
    if sched is not None:
        # resume: the snapshot's queue/lane/trial state is authoritative;
        # preset specs are re-offered (deduped against its seen/done sets)
        # and the store's completed keys merged for duplicate suppression
        for k in store.completed_keys():
            sched.queue.mark_done(k)
        for s in specs:
            sched.queue.submit(s)
        print(f"serve: resumed from {snap_path} at macro-step "
              f"{sched.stats.steps} ({sched.pool.n_live} live trial(s), "
              f"{len(sched.queue)} queued)", flush=True)
    else:
        queue = TrialQueue(specs=specs, watch_path=args.watch,
                           completed=store.completed_keys())
        queue.poll()
        print(f"serve: {queue.n_submitted} trial(s) queued; resume: "
              f"skipping {queue.n_skipped} completed/duplicate", flush=True)
        sched = TrialScheduler(queue, max_lanes=args.max_lanes, store=store,
                               pack=args.pack, verbose=args.verbose,
                               snapshot_path=snap_path,
                               snapshot_every=args.snapshot_every,
                               device=device)
    t0 = time.perf_counter()
    try:
        while True:
            steps_before = sched.stats.steps
            sched.drain(max_results=args.limit or None,
                        max_steps=args.kill_after_steps or None)
            if (args.kill_after_steps and sched.stats.steps - steps_before
                    >= args.kill_after_steps):
                print(f"serve: simulated crash after "
                      f"{args.kill_after_steps} macro-step(s); re-invoke "
                      f"with --snapshot to resume from the last boundary",
                      flush=True)
                raise SystemExit(3)
            if not args.daemon or (args.limit
                                   and sched.stats.retired >= args.limit):
                break
            time.sleep(args.poll_seconds)
    except KeyboardInterrupt:
        print("serve: interrupted; store is resumable", flush=True)
    wall = time.perf_counter() - t0

    for res in sched.results:
        print(f"  done {res.spec.key()}  acc={res.final_accuracy:.3f} "
              f"rounds={res.rounds} engine={res.engine}", flush=True)
    st = sched.stats
    dupes = (f"; {sched.duplicates_suppressed} replayed row(s) suppressed"
             if sched.duplicates_suppressed else "")
    print(f"serve: retired {st.retired} trial(s) in {wall:.1f}s over "
          f"{st.steps} step(s); mean occupancy={st.mean_occupancy:.2f} "
          f"({sched.pool.capacity} lanes, device={device}); "
          f"store={args.out}{dupes}",
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
        print(f"serve: trace -> {trace_path} ({len(obs.tracer.spans)} "
              f"spans); metrics -> {metrics_path} ({n_rows} rows) — open "
              "the trace at https://ui.perfetto.dev", flush=True)
    return sched


if __name__ == "__main__":
    main()
