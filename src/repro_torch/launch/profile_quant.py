"""Where one int8 ``fed_reduce`` call's time goes on the card: the phases
of ``fed_reduce_quant_kernel`` block by block.

    PYTHONPATH=src python -m repro_torch.launch.profile_quant [--iters 4]

Builds an instrumented copy of ``kernels/csrc/fed_reduce.cu`` (into
``build/quant_timeline/``, gitignored) in which thread 0 of every block
writes ``%globaltimer`` at the kernel's phase edges into a device array:
its start, its arrival at and departure from the first grid barrier (the
scratch zeroed), the end of its absmax phase, its arrival at and departure
from the second (every max in scratch), and its end.  Runs the call at the
main path's int8 shapes, an L2 flush (a 256 MB memset) before each launch
as ``chip_smoke.py`` times them: ``sweep`` (the layout of phase 7's
FedAvg-group launch, ``experiments/runner.py::_fused_sync_reduce``: 16
lanes of 20 rows, every other lane int8, then 192 zero-weight rows of
segment 0 padding M to 512; the 784-48-62 MLP's four leaves, N=40,718),
``resnet10`` and ``resnet34`` (T=1, M=20 every row int8, their 32 and 104
leaves).  Prints one JSON line a shape: each edge's minimum,
median, 90th percentile and maximum over the blocks in microseconds from
the first block's start (the last launch's), the number of blocks, and the
median CUDA-event time of the instrumented call and of the port's own
(``fed_reduce_quant_f32``), so that the stamps' cost shows.  Needs a GPU;
raises without one.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
from pathlib import Path

from repro_torch.kernels import build

OUT_DIR = build.BUILD_DIR.parent / "quant_timeline"
EDGES = ("start", "barrier1_arrive", "barrier1_leave", "absmax_end",
         "barrier2_arrive", "barrier2_leave", "end")
MAX_BLOCKS = 4096

_HEAD = f"""namespace fedk {{
__device__ unsigned long long g_edges[{MAX_BLOCKS} * {len(EDGES)}];
#define EDGE(i) if (threadIdx.x == 0 && blockIdx.x < {MAX_BLOCKS}) {{ \\
  unsigned long long t_; asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_)); \\
  g_edges[blockIdx.x * {len(EDGES)} + (i)] = t_; }}
"""
_TAIL = f"""
extern "C" int quant_timeline_read(unsigned long long* out) {{
  return (int)cudaMemcpyFromSymbol(out, fedk::g_edges, sizeof(fedk::g_edges));
}}
extern "C" int quant_timeline_reset() {{
  static unsigned long long zeros[{MAX_BLOCKS} * {len(EDGES)}];
  return (int)cudaMemcpyToSymbol(fedk::g_edges, zeros, sizeof(zeros));
}}
"""
# (anchor in fed_reduce.cu, its instrumented form)
_PATCHES = (
    ("namespace fedk {\n", _HEAD),
    ("  __shared__ __align__(16) QuantSmem s;\n",
     "  __shared__ __align__(16) QuantSmem s;\n  EDGE(0)\n"),
    ("    zero_maxes(q, a.M);\n    grid_sync();"
     "                                              // scratch is zero\n",
     "    zero_maxes(q, a.M);\n    EDGE(1)\n    grid_sync();\n    EDGE(2)\n"),
    ("    zero_maxes(q, a.M);\n    grid_sync();\n  }\n  if (!fold) return;",
     "    zero_maxes(q, a.M);\n    EDGE(1)\n    grid_sync();\n    EDGE(2)\n"
     "  }\n  EDGE(3)\n  if (!fold) return;"),
    ("    grid_sync();                                              "
     "// every max is in scratch\n",
     "    EDGE(4)\n    grid_sync();\n    EDGE(5)\n"),
    ("  if (!synced) grid_sync();\n}\n",
     "  if (!synced) {\n    EDGE(4)\n    grid_sync();\n    EDGE(5)\n  }\n"
     "  EDGE(6)\n}\n"),
)


def instrumented_source(text: str) -> str:
    """``fed_reduce.cu`` with the phase-edge stamps; raises if an anchor is
    not found exactly once (the kernel's source has moved on)."""
    for anchor, new in _PATCHES:
        if text.count(anchor) != 1:
            raise ValueError(f"anchor found {text.count(anchor)} times in "
                             f"fed_reduce.cu: {anchor!r}")
        text = text.replace(anchor, new)
    return text + _TAIL


def build_instrumented(out_dir: Path = OUT_DIR) -> ctypes.CDLL:
    """Builds the instrumented copy (fed_reduce.cu alone) and returns its
    library."""
    csrc = Path(out_dir) / "csrc"
    csrc.mkdir(parents=True, exist_ok=True)
    shutil.copy(build.CSRC / "common.cuh", csrc / "common.cuh")
    (csrc / "fed_reduce.cu").write_text(instrumented_source(
        (build.CSRC / "fed_reduce.cu").read_text()))
    lib = build.library(csrc.resolve(), Path(out_dir) / "kernels",
                        ("fed_reduce.cu",))
    lib.quant_timeline_read.argtypes = [ctypes.c_void_p]
    return lib


def shapes(torch):
    """(name, M, T, leaf sizes, segments, int8 mask, weighted rows) at the
    main path's int8 launches."""
    from repro_torch.configs.paper_models import RESNET10, RESNET34
    from repro_torch.models import build_model
    from repro_torch.tree import leaves

    lanes = torch.arange(16, dtype=torch.int32).repeat_interleave(20)
    pad = torch.zeros(192, dtype=torch.int32)
    seg = torch.cat([lanes, pad])
    live = torch.arange(512) < 320
    out = [("sweep", 512, 16, (48, 784 * 48, 62, 48 * 62), seg,
            live & (seg % 2 == 1), live)]
    for name, cfg in (("resnet10", RESNET10), ("resnet34", RESNET34)):
        sizes = tuple(p.numel() for p in leaves(
            build_model(cfg).init(0, "cpu")))
        out.append((name, 20, 1, sizes, torch.zeros(20, dtype=torch.int32),
                    torch.ones(20, dtype=torch.bool),
                    torch.ones(20, dtype=torch.bool)))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=4,
                    help="launches a shape; the last one's stamps are read")
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    from repro_torch.device import resolve_device
    from repro_torch.kernels import fed_reduce as fr_mod

    dev = resolve_device("cuda")
    lib, own = build_instrumented(), build.library()
    flush = torch.empty(64 * 1024 * 1024, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    gen = torch.Generator(device=dev).manual_seed(0)
    for name, m, t, sizes, seg, en, live in shapes(torch):
        n = sum(sizes)
        seg, en, live = seg.to(dev), en.to(dev), live.to(dev)
        g = torch.randn((t, n), generator=gen, device=dev) * 0.05
        rows = g[seg.long()] + torch.randn((m, n), generator=gen,
                                           device=dev) * 1e-2
        w = torch.where(live, torch.rand(m, generator=gen, device=dev)
                        + 1.0, 0.0)
        qref, enabled, off, n_leaves = fr_mod.quant_inputs(
            rows, t, sizes, g, en)
        scratch = fr_mod.quant_scratch(m, n_leaves, dev)
        out = torch.empty((t, n), device=dev)

        def call(which):
            err = which.fed_reduce_quant_f32(
                w.data_ptr(), rows.data_ptr(), seg.data_ptr(), None,
                out.data_ptr(), qref.data_ptr(), enabled.data_ptr(),
                off.data_ptr(), n_leaves, scratch.data_ptr(), m, n, t, 1,
                dev.index or 0, stream)
            if err != 0:
                raise RuntimeError(f"launch failed: CUDA error {err}")

        def median_ms(which):
            ms = []
            for _ in range(21):
                flush.zero_()
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                call(which)
                b.record()
                ms.append((a, b))
            torch.cuda.synchronize()
            ms = sorted(a.elapsed_time(b) for a, b in ms)
            return ms[len(ms) // 2]

        lib.quant_timeline_reset()
        for _ in range(args.iters):
            flush.zero_()
            call(lib)
        torch.cuda.synchronize()
        raw = (ctypes.c_ulonglong * (MAX_BLOCKS * len(EDGES)))()
        lib.quant_timeline_read(raw)
        # nanoseconds near 2^61: differences in int64, not float64
        stamps = np.array(raw, dtype=np.uint64).astype(np.int64).reshape(
            MAX_BLOCKS, len(EDGES))
        stamps = stamps[stamps[:, 0] > 0]
        t0 = stamps[:, 0].min()
        rec = dict(case=name, shape=dict(M=m, N=n, T=t, leaves=len(sizes)),
                   int8_rows=int(en.sum()), blocks=int(len(stamps)),
                   instrumented_ms=median_ms(lib), kernel_ms=median_ms(own),
                   card=torch.cuda.get_device_name(dev))
        for i, edge in enumerate(EDGES):
            col = stamps[:, i]
            us = (col[col > 0] - t0) / 1e3
            rec[edge + "_us"] = [float(np.percentile(us, p))
                                 for p in (0, 50, 90, 100)]
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
