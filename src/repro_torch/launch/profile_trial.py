"""Where a trial's time goes on the card: one sync FedTune trial under
``torch.profiler``.

    PYTHONPATH=src python -m repro_torch.launch.profile_trial [--rounds 3]

Configuration (``smoke_server``, which ``chip_smoke.py`` also drives):
``MLP_EMNIST`` at full width over the full ``emnist_like`` federation,
FedAvg, SGD lr 0.03 momentum 0.9, batch 10, M=20, E=2, FedTune preference
(0.25, 0.25, 0.25, 0.25).  One round runs first, unprofiled, to warm up.
Prints one JSON line: the same run's wall time unprofiled and profiled, the
device's busy time (the union of its kernels, copies and memsets) and idle
share in the profiled window, device activities per local step, the top
kernels by device time and operators by host time, and the server step's
device time per round: the ``fed_reduce`` kernel and the packing around it.  Needs a GPU; raises
without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

from repro_torch.federated.server import FLServer

N_PARAMS = 169_462


class CountingServer(FLServer):
    """FLServer that also counts the local optimizer steps it ran."""
    local_steps = 0

    def _client_update(self, params, cid, e):
        upd, n = super()._client_update(params, cid, e)
        self.local_steps += upd.n_steps
        return upd, n


def smoke_server(mode: str = "sync", *, m: int = 20, max_rounds: int,
                 device, buffer_k: int = 8, fleet_name=None
                 ) -> CountingServer:
    """The smoke configuration (also ``chip_smoke.py``'s): ``MLP_EMNIST``
    over the full ``emnist_like`` federation, FedAvg, SGD lr 0.03 momentum
    0.9, batch 10, E=2, FedTune on, in ``mode`` over ``fleet_name`` (None
    is the homogeneous fleet)."""
    from repro_torch.configs.paper_models import MLP_EMNIST
    from repro_torch.core import CostModel, FedTune, FedTuneConfig, Preference
    from repro_torch.core.tuner import HyperParams
    from repro_torch.data import emnist_like
    from repro_torch.federated import FLConfig, get_aggregator
    from repro_torch.models import build_model
    from repro_torch.optim.optimizers import get_optimizer
    from repro_torch.runtime import RuntimeConfig, sample_fleet

    dataset = emnist_like(seed=0)
    e = 2.0
    fleet = (None if fleet_name is None
             else sample_fleet(fleet_name, dataset.n_clients, seed=0))
    return CountingServer(
        build_model(MLP_EMNIST), dataset, get_aggregator("fedavg"),
        get_optimizer("sgd", 0.03, momentum=0.9),
        CostModel(flops_per_example=2 * N_PARAMS, param_count=N_PARAMS),
        FLConfig(m=m, e=e, batch_size=10, target_accuracy=0.99,
                 max_rounds=max_rounds, eval_points=1024),
        tuner=FedTune(FedTuneConfig(
            preference=Preference(0.25, 0.25, 0.25, 0.25)),
            HyperParams(m, e)),
        fleet=fleet, runtime_config=RuntimeConfig(mode=mode,
                                                  buffer_k=buffer_k),
        device=device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.device import resolve_device

    device = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    smoke_server(max_rounds=1, device=device).run()  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()                         # the same run, unprofiled
    smoke_server(max_rounds=args.rounds, device=device).run()
    torch.cuda.synchronize()
    plain_wall_s = time.perf_counter() - t0

    srv = smoke_server(max_rounds=args.rounds, device=device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = srv.run()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    act = device_activity(torch, prof)
    print(json.dumps(dict(
        rounds=res.rounds, local_steps=srv.local_steps,
        unprofiled_wall_s=plain_wall_s, wall_s=wall_s,
        device_busy_s=act["busy_s"],
        device_idle_share=1.0 - act["busy_s"] / wall_s,
        kernel_launches=act["activities"],
        launches_per_step=act["activities"] / max(srv.local_steps, 1),
        top_device=act["top_device"], top_host=act["top_host"],
        aggregation=aggregation_split(act["by_name"], res.rounds),
        card=card_name())), flush=True)


def aggregation_split(by_name, rounds: int) -> dict:
    """Device time per round of the server step: ``fed_reduce``'s kernel,
    and the packing around it in ``aggregation._weighted_combine`` (each
    client's flatten ``torch.cat`` and the ``torch.stack`` of the rows,
    both PyTorch's cat kernels, which nothing else of a sync trial
    launches).  ``by_name`` is ``device_activity``'s."""
    def pick(key):
        hits = [(n, ms) for name, n, ms in by_name if key in name]
        return (sum(n for n, _ in hits) / rounds,
                sum(ms for _, ms in hits) / rounds)
    pack_n, pack_ms = pick("CatArrayBatchedCopy")
    red_n, red_ms = pick("fed_reduce_kernel")
    return dict(pack_launches_per_round=pack_n, pack_ms_per_round=pack_ms,
                fed_reduce_launches_per_round=red_n,
                fed_reduce_ms_per_round=red_ms)


def card_name() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def device_activity(torch, prof, top: int = 10) -> dict:
    """Summarise a ``torch.profiler`` window: the device's busy time (the
    union of its kernels, copies and memsets), their count, each one's
    (name, count, ms) summed by name, and the top operators by host time.
    The profiler also puts each operator's name on the device timeline as
    an annotation spanning its kernels; those are left out so no time
    counts twice."""
    cuda = torch.autograd.DeviceType.CUDA
    dev_events = [e for e in prof.events() if e.device_type == cuda
                  and not getattr(e, "is_user_annotation", False)
                  and "annotation" not in str(getattr(e, "activity_type", ""))]
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev_events)
    busy_us, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            busy_us += e - max(s, end)
            end = e
    by_name = {}
    for e in dev_events:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    by_dev = sorted(by_name.items(), key=lambda kv: kv[1][1], reverse=True)
    by_cpu = sorted((e for e in prof.key_averages() if e.device_type != cuda),
                    key=lambda e: e.self_cpu_time_total, reverse=True)[:top]
    return dict(
        busy_s=busy_us / 1e6, activities=len(dev_events),
        by_name=[(name, n, us / 1e3) for name, (n, us) in by_dev],
        top_device=[(name[:80], n, us / 1e3)
                    for name, (n, us) in by_dev[:top]],
        top_host=[(e.key, e.count, e.self_cpu_time_total / 1e3)
                  for e in by_cpu])


if __name__ == "__main__":
    main()
