"""Production-mesh dry run (port of ``repro.launch.dryrun``): build every
(architecture x input shape x mesh) step on the production meshes, run
it once on ``meta`` tensors and record one rank's analysis of it.

The reference lowers and compiles each step (``.lower().compile()``) on
256 or 512 devices and reads its records from the compiled program
(``analyze_compiled``).  Here the process joins a ``fake`` process group
of 256 (16x16) or 512 (2x16x16) ranks as rank 0, builds
``make_production_mesh`` over it, takes the step and its structs from
``step_for_shape``, places the arguments as a rank holds them
(``placed_args``) and runs the step once under
``roofline.analysis.analyze_traced``: every op's DTensor sharding rule at
the production mesh is exercised (each collective a fake one, on tensors
that hold no data), nothing is allocated, and what the rank would run is
counted.  A loop that stands for one of the reference's scans walks its
first, a middle and its last step on ``meta``, and the analysis counts
the middle one for the rest (``sharding.ctx.steps``).

Each combination's record keeps the reference's keys:

  * ``flops``, ``hbm_bytes``, ``coll_bytes``, ``coll_breakdown`` (bytes
    and ``counts`` by kind), ``t_compute``, ``t_memory``,
    ``t_collective``, ``bottleneck``, ``model_flops``, ``useful_ratio``
    and ``peak_memory_bytes``: the rank's analysis on the H100's
    data-sheet peaks (``roofline.hardware.H100``); ``notes`` the kernel
    entry points counted;
  * ``memory_analysis``: ``argument_size`` (the arguments' local shards:
    params, momentum, batch, cache; checked against ``argument_bytes``),
    ``output_size``, ``alias_size`` (arguments written in place) and
    ``temp_size``, with peak = argument + output + temp - alias;
  * ``analytic``: ``roofline.analytic.analyze``'s model of the
    reference's program on the H100, as a cross-check;
  * ``t_build_s`` and ``t_run_s`` (building the step, running it) in place
    of ``t_lower_s`` and ``t_compile_s``.

A failed combination's record names the op that stopped it (``op``: the
aten op DTensor could not place, or the innermost frame of the port) and
its message (``error``).  Records go to ``experiments/dryrun_torch/``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-7b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh pod|multipod|both] [--jobs 4]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --shape train_4k --shape decode_32k --jobs 4
"""

from __future__ import annotations

import argparse
import json
import pathlib
import re
import subprocess
import sys
import tempfile
import time
import traceback
from typing import Any, Dict, Optional

import torch

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.configs.shapes import SHAPES, get_shape
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.serve import cut_layers
from repro_torch.roofline.analysis import analyze_traced
from repro_torch.roofline.analytic import analyze
from repro_torch.roofline.hardware import H100
from repro_torch.sharding import specs as sh
from repro_torch.sharding.ctx import P, to_placements
from repro_torch.tree import leaves

OUT_DIR = (pathlib.Path(__file__).resolve().parents[3] / "experiments"
           / "dryrun_torch")

# The reference's per-arch production train-step knobs, as it sets them:
# ``microbatches`` splits the round batch to bound the activation live set
# (flops unchanged).
TRAIN_KWARGS = {
    "dbrx-132b": {"microbatches": 8},
    "command-r-35b": {"microbatches": 4},
    "minitron-8b": {"microbatches": 2},
    "qwen2-7b": {"microbatches": 2},
    "recurrentgemma-9b": {"microbatches": 2},
}

# The multi-pod mesh halves the per-device batch; the reference splits
# these one more time.
TRAIN_KWARGS_MULTIPOD = {
    "dbrx-132b": {"microbatches": 8},   # mb_size must stay divisible by 32 slices
    "command-r-35b": {"microbatches": 4},
    "minitron-8b": {"microbatches": 4},
    "qwen2-7b": {"microbatches": 4},
    "recurrentgemma-9b": {"microbatches": 4},
    "gemma2-2b": {"microbatches": 2},
}


def model_flops_estimate(cfg, shape) -> float:
    """6*N*D for train (fwd+bwd), 2*N*D for prefill, 2*N per token decode;
    N = active params."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch  # decode: one token per sequence


class DryRunError(RuntimeError):
    """One (arch, shape, mesh) combo failed to build or run.

    A failure here is a bug in the port's sharding or configs, never an
    expected condition, so ``run_one`` records and saves the failing
    record, then re-raises with the combo context chained to the original
    exception.  ``main``'s sweep catches exactly this type per combo so one
    broken arch doesn't hide failures in the rest."""


def _local_bytes(x, mesh, placements) -> int:
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    shape, _ = compute_local_shape_and_global_offset(
        tuple(x.shape), mesh, placements)
    n = 1
    for d in shape:
        n *= d
    return n * x.element_size()


def argument_bytes(shape, structs, mesh, rules) -> int:
    """One rank's bytes of the step's arguments, each placed on ``mesh``
    as the step places it: params (and momentum, beside them) by
    ``param_shardings``, inputs on the batch's axes, a cache by
    ``cache_specs``; a scalar position whole."""
    p_struct = structs[0]
    pl_of = {}
    sh.tree_map_with_path(lambda path, x, pl: pl_of.setdefault(id(x), pl),
                          p_struct, sh.param_shardings(p_struct, mesh, rules))
    ps = leaves(p_struct)
    total = sum(_local_bytes(x, mesh, pl_of[id(x)]) for x in ps)
    if shape.kind == "train":
        m_struct, batch = structs[1], structs[2]
        total += sum(_local_bytes(m, mesh, pl_of[id(x)])
                     for x, m in zip(ps, leaves(m_struct)))
        inputs = list(batch.values())
    else:
        inputs = list(structs[1:])
    for x in inputs:
        if x is None:
            continue
        if isinstance(x, torch.Tensor) and x.dim() == 0:
            total += x.element_size()
        elif isinstance(x, torch.Tensor):
            spec = sh.fit_spec(P(*([rules.get("batch")]
                                   + [None] * (x.dim() - 1))), x.shape, mesh)
            total += _local_bytes(x, mesh, to_placements(spec, mesh))
        else:   # a cache (or a scales) tree
            cache_pl = []
            sh.tree_map_with_path(
                lambda path, leaf, spec: cache_pl.append(
                    (leaf, to_placements(sh.fit_spec(spec, leaf.shape, mesh),
                                         mesh))),
                x, sh.cache_specs(x, rules))
            total += sum(_local_bytes(leaf, mesh, pl)
                         for leaf, pl in cache_pl)
    return total


def placed_args(shape, structs, mesh, rules) -> list:
    """The step's arguments as a rank holds them, placed on ``mesh`` as
    ``argument_bytes`` counts them (the reference's ``in_shardings``):
    params by ``param_shardings`` and momentum beside them, the batch on
    its axes, a cache by ``cache_specs``; decode's position a host int32
    scalar (a ``meta`` tensor holds no value to index the cache by), 0:
    the new entry's slot then lies in this rank's shard of a cache split
    on its sequence, so the analysis sees the write (the step's other ops
    are the same at every position)."""
    params = sh.place_params(structs[0], mesh, rules)
    if shape.kind == "train":
        return [params, sh.place_like(structs[1], params),
                {k: sh.place_batch(v, mesh, rules)
                 for k, v in structs[2].items()}]
    if shape.kind == "prefill":
        return [params] + [sh.place_batch(x, mesh, rules)
                           for x in structs[1:]]
    return [params, sh.place_cache(structs[1], mesh, rules),
            sh.place_batch(structs[2], mesh, rules),
            torch.tensor(0, dtype=torch.int32)] \
        + list(structs[4:])


def _step_rules(shape, mesh, multi_pod: bool):
    if shape.kind == "train":
        return steps_mod.train_step_rules(multi_pod)
    if shape.kind == "prefill":
        return steps_mod.prefill_step_rules(multi_pod)
    return steps_mod.serve_step_rules(mesh, shape.global_batch, multi_pod)


def _failed_op(e: BaseException) -> str:
    """The aten op that DTensor could not place, named in the message, or
    the innermost frame of the port that raised."""
    m = re.search(r"aten\.[\w.]+", str(e))
    if m:
        return m.group(0).rstrip(".")
    frames = [f for f in traceback.extract_tb(e.__traceback__)
              if "repro_torch" in f.filename]
    if not frames:
        return type(e).__name__
    f = frames[-1]
    return (f"{f.filename.split('repro_torch/')[-1]}:{f.lineno} "
            f"({f.name})")


def _join_fake_group(n: int):
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry run joins a fake group of its own; a "
                           "process group is already up")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)


def run_one(arch: str, shape_name: str, multi_pod: bool, *,
            verbose: bool = True, save: bool = True,
            step_kwargs=None, layers: Optional[int] = None) -> Dict[str, Any]:
    """Build and run one combination on a fake group of 256 or 512 ranks
    as rank 0; return its record (``DryRunError`` on a failure).
    ``layers`` cuts depth (widths unchanged) for quick checks."""
    import torch.distributed as dist
    cfg = get_config(arch)
    if layers is not None:
        cfg = cut_layers(cfg, layers)
    shape = get_shape(shape_name)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    n_dev = 512 if multi_pod else 256
    record: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                              "mesh": mesh_name, "status": "ok",
                              "n_devices": n_dev,
                              "n_layers": cfg.n_layers}
    if step_kwargs is None and shape.kind == "train":
        step_kwargs = (TRAIN_KWARGS_MULTIPOD if multi_pod
                       else TRAIN_KWARGS).get(arch, {})
    model_flops = model_flops_estimate(cfg, shape)
    ana = analyze(cfg, shape, n_devices=n_dev)
    terms = ana.terms(H100)
    record["chip"] = H100.name
    record["analytic"] = {
        "flops": ana.flops, "hbm_bytes": ana.hbm_bytes,
        "coll_bytes": ana.coll_bytes, "t_compute": terms["compute"],
        "t_memory": terms["memory"], "t_collective": terms["collective"],
        "bottleneck": ana.bottleneck(H100),
        "useful_ratio": model_flops / (ana.flops * n_dev) if ana.flops
        else 0.0}
    _join_fake_group(n_dev)
    try:
        t0 = time.perf_counter()
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        step, structs = steps_mod.step_for_shape(
            cfg, shape, mesh=mesh, multi_pod=multi_pod,
            **(step_kwargs or {}))
        rules = _step_rules(shape, mesh, multi_pod)
        arg_bytes = argument_bytes(shape, structs, mesh, rules)
        args = placed_args(shape, structs, mesh, rules)
        t_build = time.perf_counter() - t0
        rep, mem = analyze_traced(step, args, arch=arch, shape=shape_name,
                                  mesh=mesh_name, n_devices=n_dev,
                                  model_flops=model_flops, chip=H100)
        t_run = time.perf_counter() - t0 - t_build
        if mem["argument_size"] != arg_bytes:
            raise RuntimeError(
                f"the analysis counts {mem['argument_size']} argument bytes "
                f"where the arguments' local shards hold {arg_bytes}")
        record.update(json.loads(rep.to_json()))
        record["memory_analysis"] = mem
        record["t_build_s"] = round(t_build, 2)
        record["t_run_s"] = round(t_run, 2)
        if verbose:
            print(f"[OK ] {rep.row()}  (build {t_build:.1f}s "
                  f"run {t_run:.1f}s)", flush=True)
            print(f"      memory: args={mem['argument_size']/2**30:.2f}GiB "
                  f"temp={mem['temp_size']/2**30:.2f}GiB "
                  f"out={mem['output_size']/2**30:.2f}GiB "
                  f"alias={mem['alias_size']/2**30:.2f}GiB", flush=True)
    except Exception as e:  # a failure here is a bug in the port's sharding
        record["status"] = "fail"
        record["op"] = _failed_op(e)
        record["error"] = f"{type(e).__name__}: {e}"
        if verbose:
            print(f"[FAIL] {arch} {shape_name} {mesh_name} at "
                  f"{record['op']}: {record['error'][:500]}", flush=True)
            traceback.print_exc()
        _save_record(record, arch, shape_name, mesh_name, save)
        raise DryRunError(
            f"{arch} {shape_name} {mesh_name} failed at {record['op']}: "
            f"{record['error'][:300]}") from e
    finally:
        dist.destroy_process_group()
    _save_record(record, arch, shape_name, mesh_name, save)
    return record


def _save_record(record: dict, arch: str, shape_name: str, mesh_name: str,
                 save: bool):
    if not save:
        return
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    fname = OUT_DIR / f"{arch}__{shape_name}__{mesh_name}.json"
    fname.write_text(json.dumps(record, indent=1, default=float))


def _run_children(combos, jobs: int) -> int:
    """Each combination in a child process of its own, ``jobs`` at a time,
    the training steps (the longest) first and a free slot refilled as
    soon as any child ends; each child's output is printed whole as it
    ends.  Returns the failures."""
    pending = sorted(combos, key=lambda c: get_shape(c[1]).kind != "train")
    running = []
    n_fail = 0
    while pending or running:
        while pending and len(running) < jobs:
            arch, shape_name, mp = pending.pop(0)
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape_name,
                   "--mesh", "multipod" if mp else "pod"]
            out = tempfile.TemporaryFile(mode="w+")
            running.append((subprocess.Popen(
                cmd, stdout=out, stderr=subprocess.STDOUT, text=True), out))
        done = [(p, out) for p, out in running if p.poll() is not None]
        if not done:
            time.sleep(0.1)
        for proc, out in done:
            running.remove((proc, out))
            out.seek(0)
            text = out.read()
            out.close()
            sys.stdout.write(text.split("\ndry-run complete")[0].rstrip()
                             + "\n")
            sys.stdout.flush()
            n_fail += proc.returncode != 0
    return n_fail


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES)
    ap.add_argument("--shape", choices=tuple(SHAPES), action="append",
                    help="a shape (again for more than one)")
    ap.add_argument("--mesh", choices=("pod", "multipod", "both"),
                    default="pod")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--jobs", type=int, default=1,
                    help="combinations run side by side, each in a child "
                         "process (1: all in this process, in turn)")
    args = ap.parse_args(argv)

    archs = ARCH_NAMES if (args.all or not args.arch) else (args.arch,)
    shapes = tuple(SHAPES) if (args.all or not args.shape) \
        else tuple(args.shape)
    meshes = {"pod": (False,), "multipod": (True,),
              "both": (False, True)}[args.mesh]
    combos = [(a, s, mp) for a in archs for s in shapes for mp in meshes]

    t0 = time.perf_counter()
    if args.jobs > 1 and len(combos) > 1:
        n_fail = _run_children(combos, args.jobs)
    else:
        n_fail = 0
        for arch, shape_name, mp in combos:
            try:
                run_one(arch, shape_name, mp)
            except DryRunError:
                # recorded, saved and printed by run_one; keep
                # sweeping so one broken arch doesn't mask the rest
                n_fail += 1
    print(f"\ndry-run complete; combinations: {len(combos)}; failures: "
          f"{n_fail}; seconds: {time.perf_counter() - t0:.1f}")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
