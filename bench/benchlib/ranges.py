"""The program's named ranges on a traced window's timeline: the range in
which each device operation was launched, the device time a range holds,
and the idle gaps that fall while the host is inside a step.

All of a cell's work runs on one stream, so the k-th host call that
enqueues device work (a kernel launch, an asynchronous copy or memset) is
matched to the k-th device operation, both taken by start time, and each
operation falls under the innermost program range open at its launch.
Two faults of the profiler's records, both measured on the H100, shape
the check.  Its device clock drifts from the host's, by up to 5.8 ms
within a 3 s window, where the correlation ids agree with the pairing:
an operation may read as starting before its launch, so no bound on that
lead tells a wrong pair from the drift.  And a profiler that starts late
keeps no device record of the window's first few launches (5, 6 and 94
of 8,760 in three windows of 16): those launches are dropped from the
window's start, their device time being in no busy time either.  What is checked is the
kind (a copy, a memset or a kernel) of every pair, in sequence, which a
pairing shifted by even one breaks at the next copy or memset; where a
kind differs, or there are more operations than launches, ``attribute``
returns None.

``RANGES`` is a frozen copy of ``repro_torch.obs.RANGES``: the harness
never imports the program's names, so a renamed range reads as missing.
A window without a step range (a program that opens none) reads None.
"""

from __future__ import annotations

from bisect import bisect_right
from typing import Dict, List, Optional, Tuple

RANGES = ("prefill_step", "serve_step", "embed", "norm", "qkv_proj", "rope",
          "attn_core", "cache_write", "out_proj", "mlp", "moe_router",
          "moe_expert_products", "moe_combine", "unembed",
          "slstm_step_loop")
STEPS = ("prefill_step", "serve_step")
# host calls that enqueue one device operation each
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchCooperativeKernel",
            "cuLaunchKernel", "cuLaunchCooperativeKernel", "cudaMemcpy",
            "cudaMemset", "cuMemcpy", "cuMemset")


def _kind(name: str) -> str:
    """A launch's or a device operation's kind: copy, memset or kernel."""
    n = name.lower()
    return "copy" if "memcpy" in n else "memset" if "memset" in n \
        else "kernel"


def attribute(t) -> Optional[List[Tuple[Optional[str], float]]]:
    """Each device operation of the trace ``t`` (``benchlib.trace.Trace``)
    as (the innermost program range open at its launch, or None outside
    every one; its device seconds), or None where the launches and the
    operations do not pair, or the window holds no step range."""
    launches = sorted((s, n) for n, s, _ in t.host
                      if n.startswith(LAUNCHES))
    ops = sorted(t.device, key=lambda x: x[1])
    ranges = sorted((s, e, n) for n, s, e in t.host if n in RANGES)
    lost = len(launches) - len(ops)
    if lost < 0 or not any(r[2] in STEPS for r in ranges):
        return None
    out, stack, i = [], [], 0
    for (at, call), (name, s, e) in zip(launches[lost:], ops):
        if _kind(call) != _kind(name):
            return None
        while i < len(ranges) and ranges[i][0] <= at:
            while stack and stack[-1][1] < ranges[i][0]:
                stack.pop()
            stack.append(ranges[i])
            i += 1
        while stack and stack[-1][1] < at:
            stack.pop()
        out.append((stack[-1][2] if stack else None, (e - s) / 1e6))
    return out


def share(t, names) -> Optional[float]:
    """The device time of the operations launched inside the ranges
    ``names`` (innermost), over the window's busy time, in %."""
    ops = attribute(t)
    busy = t.busy_s()
    if ops is None or busy <= 0:
        return None
    return 100.0 * sum(d for r, d in ops if r in names) / busy


def step_idle_share(t, step: str) -> Optional[float]:
    """The idle gaps between the device's operations whose midpoint falls
    while the host is inside a ``step`` range, over the window, in %."""
    steps = sorted((s, e) for n, s, e in t.host if n == step)
    if t.window_s <= 0 or not t.device or not steps:
        return None
    starts = [s for s, _ in steps]
    idle, end = 0.0, None
    for _, s, e in sorted(t.device, key=lambda x: x[1]):
        if end is not None and s > end:
            mid = 0.5 * (s + end)
            k = bisect_right(starts, mid) - 1
            if k >= 0 and steps[k][1] >= mid:
                idle += s - end
        end = e if end is None else max(end, e)
    return 100.0 * idle / 1e6 / t.window_s


def table(t) -> Optional[Dict[str, Dict[str, float]]]:
    """Per program range (and ``"(outside)"``, every range closed): the
    device seconds and operations launched inside it (innermost), and its
    host self seconds (its length less its inner ranges'), each summed
    over the window; None where ``attribute`` is."""
    ops = attribute(t)
    if ops is None:
        return None
    rows: Dict[str, Dict[str, float]] = {}

    def row(name):
        return rows.setdefault(name, {"device_s": 0.0, "launches": 0,
                                      "host_self_s": 0.0})
    for r, d in ops:
        x = row(r or "(outside)")
        x["device_s"] += d
        x["launches"] += 1
    stack: List[list] = []      # [start, end, name, inner seconds]

    def close(x):
        row(x[2])["host_self_s"] += ((x[1] - x[0]) - x[3]) / 1e6
        if stack:
            stack[-1][3] += x[1] - x[0]
    for s, e, n in sorted((s, e, n) for n, s, e in t.host if n in RANGES):
        while stack and stack[-1][1] < s:
            close(stack.pop())
        stack.append([s, e, n, 0.0])
    while stack:
        close(stack.pop())
    return rows
