"""Readings for a cell's limits: the program's and the control's numbers
on several seeds, in one process.

    python bench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        [--seconds 5] [--fault token] [--no-control] [--out PATH]

Each seed runs the cell as ``bench/run.py`` does (set-up, a short window,
the check) and also reads the control: the reference in float8 e4m3 put in
the program's place, judged by the same limits and the same predicate as
the program (``control.correct``).  ``--fault token`` alters a served token
where it is produced.  Prints one JSON line a seed (and appends it to
``--out``).  Needs a GPU.
"""

import time

import argparse
import gc
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--fault", choices=("token",), default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--no-control", action="store_true")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(HERE.parent / "src"), str(HERE)]
    import torch
    from benchlib import harness
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        torch.cuda.reset_peak_memory_stats()
        out = harness.run_cell(args.workload, seed, args.seconds, False,
                               "cuda:0", time.perf_counter(),
                               fault=args.fault,
                               control=not args.no_control)
        line = json.dumps(dict(workload=args.workload, seed=seed,
                               fault=args.fault,
                               card=torch.cuda.get_device_name(0), **out))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
