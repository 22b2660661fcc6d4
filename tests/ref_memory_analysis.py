"""The reference's own memory figures for the port's dry run to sit beside.

Compiles the JAX package's production steps (``repro.launch.steps``) for
gemma2-2b on a 16x16 ``jax.sharding.Mesh`` of XLA CPU host devices and
prints each compiled program's ``memory_analysis()`` per device, as
``repro.launch.dryrun`` records it.  The mesh is built with Auto axes
(``jax.sharding.Mesh``): under this JAX ``jax.make_mesh`` makes Explicit
ones, which the reference's sharding constraints refuse, so its own
``dryrun`` cannot run as it is.  Nothing in ``src/repro`` is changed.

Not collected by pytest (the name does not start with ``test_``).  Usage:

  PYTHONPATH=src python tests/ref_memory_analysis.py \\
      [--arch gemma2-2b ...] [--shape train_4k --shape prefill_32k ...] \\
      [--json OUT]

Each shape is compiled in a child process of its own (a fresh XLA
client), one after the other; a shape that fails to compile or runs past
``--timeout`` seconds is reported as such, and the others still run.
The train step takes ``repro.launch.dryrun``'s per-arch knobs.
"""

import argparse
import json
import os
import subprocess
import sys
import time

_CHILD = r"""
import os, sys, json, time
os.environ.setdefault("JAX_PLATFORMS", "cpu")
import numpy as np
from repro.launch import dryrun     # sets XLA_FLAGS to 512 host devices
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=256"
import jax
from jax.sharding import Mesh
from repro.configs import get_config
from repro.configs.shapes import get_shape
from repro.launch.steps import step_for_shape

arch, shape_name = sys.argv[1], sys.argv[2]
cfg, shape = get_config(arch), get_shape(shape_name)
mesh = Mesh(np.array(jax.devices()[:256]).reshape(16, 16),
            ("data", "model"))
kw = dryrun.TRAIN_KWARGS.get(arch, {}) if shape.kind == "train" else {}
t0 = time.perf_counter()
jit_fn, structs = step_for_shape(cfg, mesh, shape, **kw)
with mesh:
    lowered = jit_fn.lower(*structs)
    t_lower = time.perf_counter() - t0
    compiled = lowered.compile()
t_compile = time.perf_counter() - t0 - t_lower
mem = compiled.memory_analysis()
rec = {"arch": arch, "shape": shape_name, "mesh": "16x16",
       "step_kwargs": kw,
       "argument_size": mem.argument_size_in_bytes,
       "output_size": mem.output_size_in_bytes,
       "temp_size": mem.temp_size_in_bytes,
       "alias_size": mem.alias_size_in_bytes,
       "t_lower_s": round(t_lower, 2), "t_compile_s": round(t_compile, 2)}
rec["peak_bytes"] = (rec["argument_size"] + rec["output_size"]
                     + rec["temp_size"] - rec["alias_size"])
print(json.dumps(rec))
"""


def compile_one(arch: str, shape: str, timeout: float) -> dict:
    env = dict(os.environ)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([sys.executable, "-c", _CHILD, arch, shape],
                              env=env, capture_output=True, text=True,
                              timeout=timeout)
    except subprocess.TimeoutExpired:
        return {"arch": arch, "shape": shape, "status": "timeout",
                "seconds": round(time.perf_counter() - t0, 1)}
    if proc.returncode != 0:
        return {"arch": arch, "shape": shape, "status": "fail",
                "error": proc.stderr.strip().splitlines()[-1:],
                "seconds": round(time.perf_counter() - t0, 1)}
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    rec.update(status="ok", seconds=round(time.perf_counter() - t0, 1))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", action="append",
                    help="an arch (again for more; default gemma2-2b)")
    ap.add_argument("--shape", action="append",
                    help="a shape (again for more; default train_4k and "
                         "prefill_32k)")
    ap.add_argument("--timeout", type=float, default=1800.0)
    ap.add_argument("--json", help="write the records here as well")
    args = ap.parse_args(argv)
    out = []
    combos = [(a, sh) for a in args.arch or ["gemma2-2b"]
              for sh in args.shape or ["train_4k", "prefill_32k"]]
    for arch, shape in combos:
        rec = compile_one(arch, shape, args.timeout)
        out.append(rec)
        if rec["status"] == "ok":
            print(f"{rec['arch']} {rec['shape']} 16x16: argument "
                  f"{rec['argument_size']} output {rec['output_size']} temp "
                  f"{rec['temp_size']} alias {rec['alias_size']} -> peak "
                  f"{rec['peak_bytes']} B ({rec['peak_bytes'] / 2**30:.2f} "
                  f"GiB; compiled in {rec['t_compile_s']} s)", flush=True)
        else:
            print(f"{rec['arch']} {rec['shape']} 16x16: {rec['status']} "
                  f"after {rec['seconds']} s {rec.get('error', '')}",
                  flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
