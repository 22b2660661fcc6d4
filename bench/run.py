"""Run one benchmark cell once on this machine's GPU.

    python bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Sets up (the program's kernel library from ``build/kernels/``, built there
on a checkout's first run, its seconds reported apart as
``kernel_library``; weights and inputs drawn on the device from the seed),
warms up on the cell's own shapes, measures for ``--seconds`` in whole
steps (``--trace 0``: the end-to-end metrics) or times the cell's
``trace_steps`` untraced and then traces as many under ``torch.profiler``
(``--trace 1``: the per-layer metrics), then checks what the timed path
produced against the plain reference.  Prints each number checked beside its limit on standard error,
and one JSON object as the last line of standard output.  Exits non-zero
without a result when there is no GPU, when the cell asks for more GPUs
than there are, or when a JAX module or the JAX package is loaded once the
window has closed.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(HERE.parent / "src"), str(HERE)]

    import torch
    from benchlib import harness

    wl = harness.workload(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < wl["chips"]:
        print(f"{args.workload} needs {wl['chips']} CUDA device(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = harness.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), "cuda:0", T0)
    lib = out["kernel_library"]
    print(f"kernel library {lib['seconds']!r} s of setup_s, built "
          f"{lib['built']}", file=sys.stderr)
    print(f"correct {out['correct']}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
