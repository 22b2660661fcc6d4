"""Where a cell's traced window goes by the program's named ranges.

    python bench/range_table.py --workload <cell> --seed <n>

Sets the cell up and warms it as ``bench/run.py`` does, times its
``trace_steps`` untraced, then traces as many under ``torch.profiler``, and
prints one JSON object: for each program range (``benchlib.ranges``), and
for the operations launched outside every range, the device milliseconds,
the operations and the host self milliseconds a step; the window's busy
time and the sum of the rows' device time; the host calls that launch
device work beside the device's operations, by name (the pairing's
counts), the launches left without a device record at the window's
start (``lost``), and the least time by which an operation starts
after its launch (negative where the profiler's clocks drift apart);
and the per-layer metrics of ``BENCHMARK.json`` that list the cell.  Checks nothing against the
reference.  Needs a GPU.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from collections import Counter  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(HERE.parent / "src"), str(HERE)]

    import torch
    from torch.profiler import ProfilerActivity, profile

    from benchlib import harness, ranges
    from benchlib.trace import read_profile

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    dev = "cuda:0"
    wl = harness.workload(args.workload)
    cfg = harness.config(wl["config"])["model"]
    harness.kernel_library()
    entry = harness.entry_class(wl["entry"])(
        harness.Run(args.workload, wl, cfg, args.seed, dev))
    entry.warmup()
    harness.sync(dev)
    setup_s = time.perf_counter() - T0
    n = wl["trace_steps"]
    timed_s = harness._timed(entry, dev, n)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        window_s = harness._timed(entry, dev, n)
    t = read_profile(torch, prof, window_s, n, timed_s)

    rows = ranges.table(t) or {}
    per_step = {k: {"device_ms": 1e3 * v["device_s"] / n,
                    "launches": v["launches"] / n,
                    "host_self_ms": 1e3 * v["host_self_s"] / n}
                for k, v in sorted(rows.items(),
                                   key=lambda kv: -kv[1]["device_s"])}
    spec = harness.load_json(HERE.parent / "BENCHMARK.json")
    metrics = {m["name"]: harness.metric_reader(m["name"])(t)
               for m in harness.cell_metrics(spec, args.workload)
               ["per_layer"]}
    calls = sorted(s for name, s, _ in t.host
                   if name.startswith(ranges.LAUNCHES))
    starts = sorted(s for _, s, _ in t.device)
    lost = len(calls) - len(starts)
    launches = Counter(name for name, _, _ in t.host
                       if name.startswith(ranges.LAUNCHES))
    print(json.dumps(dict(
        cell=args.workload, seed=args.seed, steps=n, setup_s=setup_s,
        untraced_window_s=timed_s, window_s=window_s, busy_s=t.busy_s(),
        rows_device_s=sum(v["device_s"] for v in rows.values()),
        device_ops=len(t.device), launch_calls=dict(launches),
        lost=lost, least_lead_us=min(
            (b - a for a, b in zip(calls[max(lost, 0):], starts)),
            default=None),
        paired=bool(rows), per_step=per_step, metrics=metrics,
        card=torch.cuda.get_device_name(0))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
