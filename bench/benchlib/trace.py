"""Reading a ``torch.profiler`` window: the device's kernels by class, its
busy time, and the breakdown of the result line.

``kernel_class`` is a copy of ``kernel_class`` in
``src/repro_torch/launch/profile_train.py`` (the harness never calls the
program's copy); ``read_profile`` follows ``device_activity`` in
``src/repro_torch/launch/profile_trial.py``: the device's kernels, copies
and memsets, without the operator annotations that the profiler also puts
on the device's timeline.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np


def kernel_class(name: str) -> str:
    n = name.lower()
    if "attn_bwd_" in n or "attn16_bwd_" in n:
        return "flash_attention_bwd"
    if "flash_attention_kernel" in n or "flash_attention_bf16_kernel" in n:
        return "flash_attention"
    if "rglru_scan_bwd_kernel" in n:
        return "rglru_scan_bwd"
    if "rglru_scan_kernel" in n or "rglru_scan_bf16_kernel" in n:
        return "rglru_scan"
    if "memcpy" in n or "memset" in n:
        return "copies"
    if any(k in n for k in ("gemm", "gemv", "cutlass", "xmma", "dot_kernel",
                            "nvjet")):
        return "matmul"
    return "elementwise_and_other"


@dataclass
class Trace:
    """One traced window: its device events (name, start us, end us), its
    host operators (name, start us, end us), its length (s) and the steps
    in it; the seconds that as many steps took untraced just before it
    (``timed_s``: the profiler slows the host's dispatch), and one step's
    counts (``benchlib.counts``)."""
    window_s: float
    steps: int
    device: List[Tuple[str, float, float]]
    host: List[Tuple[str, float, float]]
    timed_s: float
    counts: Dict[str, float] = field(default_factory=dict)

    def busy_s(self) -> float:
        """The union of the device's busy intervals."""
        busy, end = 0.0, float("-inf")
        for _, s, e in sorted(self.device, key=lambda x: x[1]):
            if e > end:
                busy += e - max(s, end)
                end = e
        return busy / 1e6

    def class_time_s(self, cls: str) -> Tuple[int, float]:
        """Launches and summed device seconds of one kernel class."""
        ev = [(s, e) for n, s, e in self.device if kernel_class(n) == cls]
        return len(ev), sum(e - s for s, e in ev) / 1e6

    def kernels(self) -> int:
        """Device kernels (copies and memsets left out)."""
        return sum(1 for n, _, _ in self.device
                   if kernel_class(n) != "copies")

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        """The device operations that took most time, and the longest idle
        gaps (the 1,000 longest) named by the innermost host operator
        running across each gap's middle, summed by that name."""
        by_name: Dict[str, float] = {}
        for n, s, e in self.device:
            by_name[n] = by_name.get(n, 0.0) + (e - s) / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps, end = [], None
        for _, s, e in sorted(self.device, key=lambda x: x[1]):
            if end is not None and s > end:
                gaps.append((end, s))
            end = e if end is None else max(end, e)
        by_gap: Dict[str, float] = {}
        hs = np.array([h[1] for h in self.host], dtype=np.float64)
        he = np.array([h[2] for h in self.host], dtype=np.float64)
        for g0, g1 in sorted(gaps, key=lambda g: g[0] - g[1])[:1000]:
            mid = 0.5 * (g0 + g1)
            inside = np.nonzero((hs <= mid) & (he >= mid))[0]
            name = "(no host operator)" if inside.size == 0 else \
                self.host[inside[np.argmin((he - hs)[inside])]][0]
            by_gap[name] = by_gap.get(name, 0.0) + (g1 - g0) / 1e6
        idle = sorted(by_gap.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:120], v] for n, v in ops],
                "idle_gaps": [[n[:120], v] for n, v in idle]}


def read_profile(torch, prof, window_s: float, steps: int,
                 timed_s: float) -> Trace:
    """A ``torch.profiler.profile`` object's window as a ``Trace``."""
    cuda = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    for e in prof.events():
        if e.device_type == cuda:
            if getattr(e, "is_user_annotation", False) or \
                    "annotation" in str(getattr(e, "activity_type", "")):
                continue
            dev.append((e.name, e.time_range.start, e.time_range.end))
        else:
            host.append((e.name, e.time_range.start, e.time_range.end))
    return Trace(window_s=window_s, steps=steps, device=dev, host=host,
                 timed_s=timed_s)
