"""Running one cell: everything is found by name.

  bench/workloads/<cell>.json   the cell: its configuration, its entry, the
                                traffic's parameters, the limits of its
                                checks, the steps its traced run traces
  bench/configs/<config>.json   the configuration as it is run (``model``)
  bench/entries/<entry>.py      drives the entry's traffic through the
                                program and checks it against the reference
  bench/metrics/<metric>.py     reads one per-layer metric from a trace

``BENCHMARK.json`` at the checkout's root lists the cells and metrics; the
harness reports, for a cell, the metrics that list it.
"""

from __future__ import annotations

import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Any, Dict, Optional

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def _module(path: Path, name: str):
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def workload(name: str, bench: Path = BENCH) -> Dict[str, Any]:
    return load_json(bench / "workloads" / f"{name}.json")


def config(name: str, bench: Path = BENCH) -> Dict[str, Any]:
    return load_json(bench / "configs" / f"{name}.json")


def entry_class(entry: str, bench: Path = BENCH):
    return _module(bench / "entries" / f"{entry}.py",
                   f"bench_entry_{entry}").Entry


def metric_reader(name: str, bench: Path = BENCH):
    return _module(bench / "metrics" / f"{name}.py",
                   "bench_metric_" + name.replace(".", "_")).read


def cell_metrics(spec: Dict[str, Any], cell: str) -> Dict[str, list]:
    """The end-to-end and per-layer metrics of ``BENCHMARK.json``
    (``spec``) that ``cell`` reports: those that list it, and those that
    list no cells (a per-layer one where the cell reports what it
    moves)."""
    e2e = [m for m in spec["end_to_end"]
           if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    per = [m for m in spec["per_layer"]
           if (cell in m["workloads"] if "workloads" in m
               else m["moves"] in names)]
    return {"end_to_end": e2e, "per_layer": per}


def program_config(model: Dict[str, Any]):
    """The program's ``ModelConfig`` for a configuration file's ``model``
    block."""
    from repro_torch.configs.base import (FFN_DENSE, FFN_MOE, ModelConfig,
                                          MoEConfig, uniform_layers)
    moe = model.get("moe")
    return ModelConfig(
        name=model["name"], family="moe" if moe else "dense",
        n_layers=model["n_layers"], d_model=model["d_model"],
        n_heads=model["n_heads"], n_kv_heads=model["n_kv_heads"],
        head_dim=model["head_dim"], d_ff=model["d_ff"],
        vocab_size=model["vocab_size"],
        layers=uniform_layers(model["n_layers"],
                              ffn=FFN_MOE if moe else FFN_DENSE),
        moe=None if moe is None else MoEConfig(
            n_experts=moe["n_experts"], top_k=moe["top_k"],
            d_ff_expert=moe["d_ff_expert"],
            aux_loss_coef=moe["aux_loss_coef"]),
        qkv_bias=model["qkv_bias"], rope_theta=model["rope_theta"],
        norm_eps=model["norm_eps"], tie_embeddings=model["tie_embeddings"],
        act=model["act"])


def forbidden_modules():
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def kernel_library() -> Dict[str, Any]:
    """Loads the program's kernel library, building it first where this
    checkout has none (its first run): the seconds it took and whether it
    built.  Part of ``setup_s``; reported apart so that a checkout's first
    run can be told from a warm one."""
    from repro_torch.kernels import build
    t = time.perf_counter()
    built = not build.library_path().is_file()
    build.library()
    return {"seconds": time.perf_counter() - t, "built": built}


def judge(readings: Dict[str, float], limits: Dict[str, float]):
    """Each number beside its limit, and whether every one is within it:
    the one predicate that decides ``correct``, for the program and for
    the control alike."""
    checks = {k: {"value": v, "limit": limits.get(k)}
              for k, v in readings.items()}
    ok = all(c["limit"] is not None and math.isfinite(c["value"])
             and c["value"] <= c["limit"] for c in checks.values())
    return checks, bool(ok)


class Run:
    """What an entry is given: the configuration's ``model`` block
    (``cfg``), the program's config (``pcfg``), the cell's traffic, the
    seed, the device, and a planted fault (tests and calibration)."""

    def __init__(self, cell: str, wl: Dict[str, Any], cfg: Dict[str, Any],
                 seed: int, device, fault: Optional[str] = None):
        self.cell, self.wl, self.cfg = cell, wl, cfg
        self.traffic = wl["traffic"]
        self.seed, self.device, self.fault = int(seed), device, fault
        self.pcfg = program_config(cfg)


def _timed(entry, device, steps: int) -> float:
    """Seconds that ``steps`` steps take, untraced."""
    w0 = time.perf_counter()
    for _ in range(steps):
        entry.step()
    sync(device)
    return time.perf_counter() - w0


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device,
             t0: float, *, bench: Path = BENCH, spec=None,
             fault: Optional[str] = None, model=None, traffic=None,
             control: bool = False) -> Dict[str, Any]:
    """Set up, warm up, then measure for ``seconds`` (``trace`` off), or
    (``trace`` on) time the cell's ``trace_steps`` untraced and trace as
    many more under ``torch.profiler``; check against the reference.
    ``model`` and ``traffic`` replace the files' (tests at a small size).
    Returns the result line's fields, ``checks`` last; with ``control``
    also the control's readings judged by the same limits
    (``control``)."""
    import torch
    wl = workload(cell, bench)
    cfg = dict(config(wl["config"], bench)["model"], **(model or {}))
    if traffic:
        wl = dict(wl, traffic=dict(wl["traffic"], **traffic))
    spec = spec if spec is not None else load_json(bench.parent
                                                    / "BENCHMARK.json")
    mine = cell_metrics(spec, cell)
    cuda = torch.device(device).type == "cuda"
    lib = kernel_library() if cuda else None
    run = Run(cell, wl, cfg, seed, device, fault)
    entry = entry_class(wl["entry"], bench)(run)
    entry.warmup()
    sync(device)
    setup_s = time.perf_counter() - t0

    trace_obj = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        from benchlib.trace import read_profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if cuda else [])
        n = steps = wl["trace_steps"]
        timed_s = _timed(entry, device, n)
        step_counts = entry.counts()
        with profile(activities=acts) as prof:
            window_s = _timed(entry, device, n)
        trace_obj = read_profile(torch, prof, window_s, n, timed_s)
        trace_obj.counts = step_counts
    else:
        steps = 0
        w0 = time.perf_counter()
        while True:
            entry.step()
            steps += 1
            window_s = time.perf_counter() - w0
            if window_s >= seconds:
                break
    bad = forbidden_modules()
    if bad:
        raise SystemExit("loaded after the window: " + ", ".join(bad))
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    metrics: Dict[str, Dict[str, float]] = {}
    if trace:
        for m in mine["per_layer"]:
            v = metric_reader(m["name"], bench)(trace_obj)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        got = dict(entry.end_to_end(window_s, steps), setup_s=setup_s)
        for m in mine["end_to_end"]:
            metrics[m["name"]] = {"value": got[m["name"]], "unit": m["unit"]}
    entry.release()
    readings = entry.check(control=control)
    if control:
        readings, ctl = readings
    checks, correct = judge(readings, wl["limits"])
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    out: Dict[str, Any] = {"correct": correct, "attempted": steps,
                           "failed": 0, "metrics": metrics, "device": dev}
    if lib is not None:
        out["kernel_library"] = lib
    if trace:
        dev["busy_s"] = trace_obj.busy_s()
        dev["window_s"] = window_s
        out["untraced_window_s"] = timed_s
        out["breakdown"] = trace_obj.breakdown()
    if control:
        ctl_checks, ctl_correct = judge(ctl, wl["limits"])
        out["control"] = {"correct": ctl_correct, "checks": ctl_checks}
    out["checks"] = checks
    return out
