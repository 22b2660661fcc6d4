"""Where a packed sweep round's time goes on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_sweep [--rounds 3]

Configuration (``full_width_grid``, which ``chip_smoke.py`` phase 7 also
drives): the 48-trial sync grid at paper scale (``reduced=False``: the full
``emnist_like`` federation of 2,520 clients, the sweep's ``hidden=(48,)``
MLP with 40,718 params), aggregators fedavg, fednova and fedadam,
preferences 0, 3 and 14 of the paper's list, seeds 0 and 1, (M0, E0) =
(20, 1.0), compression none and int8, batch 10, 512 eval points, FedTune
and fixed baselines.

Two runs of ``run_sweep``, after a one-round warm-up:

  1. Timed by phase.  Each phase's host time is summed over the run, with a
     device sync at the end of every timed call so device work is charged
     to the phase that launched it: plan (``plan_sync_round``), pack (client
     data and batch streams), host staging (filling the bucket arrays, and
     their copies to the card), train (the packed cohort steps, the int8
     lane round trip and the flatten), reduce (the fused FedAvg
     ``fed_reduce`` and every trial's aggregation and accounting), eval (the
     stacked evaluations), and the rest.
  2. Under ``torch.profiler``, with no syncs added: the device's busy time
     (the union of its kernels, copies and memsets), its idle share over
     the run's wall time, and the top kernels.

Prints one JSON line.  Needs a GPU; raises without one.
"""

from __future__ import annotations

import argparse
import json
import time


def full_width_grid(rounds: int = 5):
    """The 48-trial sync grid of ``chip_smoke.py`` phase 7 (fixed
    baselines collapsed over the preference axis)."""
    from repro_torch.experiments import SweepSpec, TrialSpec, parse_preferences
    return SweepSpec(
        datasets=("emnist",),
        aggregators=("fedavg", "fednova", "fedadam"),
        preferences=parse_preferences("0,3,14"),
        seeds=(0, 1),
        inits=((20, 1.0),),
        compressions=(None, "int8"),
        base=TrialSpec(rounds=rounds, target_accuracy=0.99, batch_size=10,
                       eval_points=512, reduced=False))


def full_width_event_grid(rounds: int = 10):
    """The async/buffered counterpart: FedAvg, preference 14, seeds 0 and
    1, (M0, E0) = (20, 1.0), the stragglers fleet; 8 trials."""
    from repro_torch.experiments import SweepSpec, TrialSpec, parse_preferences
    return SweepSpec(
        datasets=("emnist",),
        aggregators=("fedavg",),
        preferences=parse_preferences("14"),
        seeds=(0, 1),
        inits=((20, 1.0),),
        modes=("async", "buffered"),
        hets=("stragglers",),
        base=TrialSpec(rounds=rounds, target_accuracy=0.99, batch_size=10,
                       eval_points=512, reduced=False))


class PhaseTimer:
    """Wraps functions so each call's host time (ending in a device sync)
    is summed under a phase name; ``restore`` undoes every wrap."""

    def __init__(self, torch):
        self.torch = torch
        self.seconds = {}
        self.calls = {}
        self._undo = []

    def wrap(self, owner, attr: str, phase: str):
        inner = getattr(owner, attr)
        sync = self.torch.cuda.synchronize

        def timed(*args, **kw):
            t0 = time.perf_counter()
            out = inner(*args, **kw)
            sync()
            self.seconds[phase] = (self.seconds.get(phase, 0.0)
                                   + time.perf_counter() - t0)
            self.calls[phase] = self.calls.get(phase, 0) + 1
            return out
        setattr(owner, attr, timed)
        self._undo.append((owner, attr, inner))

    def restore(self):
        for owner, attr, inner in reversed(self._undo):
            setattr(owner, attr, inner)
        self._undo = []


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data.synthetic import FederatedDataset
    from repro_torch.device import resolve_device
    from repro_torch.experiments import run_sweep
    from repro_torch.experiments import runner
    from repro_torch.launch.profile_trial import card_name, device_activity
    from repro_torch.runtime.engine import EventDrivenRuntime

    device = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    run_sweep(full_width_grid(rounds=1).expand(), device=device)  # warm-up
    specs = full_width_grid(rounds=args.rounds).expand()

    timer = PhaseTimer(torch)
    timer.wrap(EventDrivenRuntime, "plan_sync_round", "plan")
    timer.wrap(FederatedDataset, "client_data", "pack")
    timer.wrap(runner, "materialize_streams", "pack")
    timer.wrap(runner, "_stack_streams", "host_staging")
    timer.wrap(runner, "to_device", "host_staging")
    timer.wrap(runner, "_run_group_batched", "train_incl_staging")
    timer.wrap(runner, "_fused_sync_reduce", "reduce")
    timer.wrap(runner, "_reduce_round", "reduce")
    timer.wrap(runner, "evaluate_stacked", "eval")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_sweep(specs, device=device)
    torch.cuda.synchronize()
    timed_wall = time.perf_counter() - t0
    timer.restore()
    phases = dict(timer.seconds)
    phases["train"] = (phases.pop("train_incl_staging")
                       - phases["host_staging"])
    phases["rest"] = timed_wall - sum(phases.values())

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = run_sweep(specs, device=device)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    act = device_activity(torch, prof)
    trial_rounds = sum(r.rounds for r in res)
    steps = sum(r.local_steps for r in res)
    print(json.dumps(dict(
        trials=len(res), sweep_rounds=args.rounds, trial_rounds=trial_rounds,
        local_steps=steps, timed_wall_s=timed_wall,
        phase_s=phases, phase_share={k: v / timed_wall
                                     for k, v in phases.items()},
        phase_calls=timer.calls,
        profiled_wall_s=wall_s, device_busy_s=act["busy_s"],
        device_idle_share=1.0 - act["busy_s"] / wall_s,
        device_activities=act["activities"],
        activities_per_step=act["activities"] / max(steps, 1),
        top_device=act["top_device"], top_host=act["top_host"],
        card=card_name())), flush=True)


if __name__ == "__main__":
    main()
