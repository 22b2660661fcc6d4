"""The readers of the program's ranges (``benchlib.ranges`` and the metrics
that use it) against hand-made traces: the k-th launch paired with the
k-th device operation, the innermost range at a launch, launches without
a device record at the window's start dropped, nothing where the pairing
fails or the window holds no step, idle gaps by their midpoint; and the
frozen range names against the program's."""

import pytest

from benchlib import harness, ranges
from benchlib.trace import Trace


def trace(device, host, *, window_s=1e-3):
    return Trace(window_s=window_s, steps=1, device=list(device),
                 host=list(host), timed_s=window_s)


def read(name, t):
    return harness.metric_reader(name)(t)


# one decode step (us): serve_step [0, 100] holds attn_core [10, 40] and
# the MoE's three ranges; the harness's own argmax launches after it
HOST = [("serve_step", 0, 100), ("attn_core", 10, 40),
        ("cudaLaunchKernel", 12, 13), ("aten::copy_", 14, 20),
        ("cudaMemcpyAsync", 15, 16), ("moe_router", 45, 55),
        ("cuLaunchKernel", 50, 51), ("moe_expert_products", 56, 70),
        ("cudaLaunchKernelExC", 60, 61), ("moe_combine", 71, 80),
        ("cudaLaunchKernel", 75, 76), ("cudaLaunchKernel", 90, 91),
        ("cudaStreamSynchronize", 101, 150), ("cudaLaunchKernel", 110, 111)]
DEV = [("magma_sgemmEx", 20, 40), ("Memcpy DtoD", 40, 50),
       ("router_gemm", 52, 54), ("nvjet_expert", 62, 72),
       ("combine", 80, 84), ("residual_add", 92, 96),
       ("argmax", 140, 150)]


def test_each_operation_falls_under_its_launchs_innermost_range():
    # the profiler's device clock drifts from the host's by milliseconds:
    # an operation read before its launch still pairs
    skewed = [(n, s - 5800, e) if n == "magma_sgemmEx" else (n, s, e)
              for n, s, e in DEV]
    assert ranges.attribute(trace(skewed, HOST))[0][0] == "attn_core"
    got = ranges.attribute(trace(DEV, HOST))
    assert [r for r, _ in got] == [
        "attn_core", "attn_core", "moe_router", "moe_expert_products",
        "moe_combine", "serve_step", None]
    assert [d for _, d in got] == pytest.approx(
        [20e-6, 10e-6, 2e-6, 10e-6, 4e-6, 4e-6, 10e-6])
    rows = ranges.table(trace(DEV, HOST))
    assert rows["attn_core"]["launches"] == 2
    assert rows["attn_core"]["device_s"] == pytest.approx(30e-6)
    assert rows["(outside)"]["device_s"] == pytest.approx(10e-6)
    # serve_step's 100 us less its four inner ranges' 30 + 10 + 14 + 9
    assert rows["serve_step"]["host_self_s"] == pytest.approx(37e-6)
    assert rows["attn_core"]["host_self_s"] == pytest.approx(30e-6)
    assert sum(r["device_s"] for r in rows.values()) == pytest.approx(
        trace(DEV, HOST).busy_s())


def test_shares_of_the_busy_time():
    t = trace(DEV, HOST)
    busy = 60.0
    assert read("attn_core_share.decode", t) == \
        pytest.approx(100 * 30 / busy)
    assert read("moe_share.decode", t) == pytest.approx(100 * 16 / busy)
    host = [("prefill_step", 0, 100), ("norm", 5, 30),
            ("cudaLaunchKernel", 6, 7), ("qkv_proj", 30, 60),
            ("rope", 40, 50), ("cudaLaunchKernel", 45, 46),
            ("cudaLaunchKernel", 55, 56)]
    dev = [("rms", 10, 20), ("cos", 50, 55), ("gemm", 60, 90)]
    assert read("norm_rope_share.prefill", trace(dev, host)) == \
        pytest.approx(100 * 15 / 45)


@pytest.mark.parametrize("name", ["attn_core_share.decode",
                                  "moe_share.decode",
                                  "norm_rope_share.prefill"])
def test_nothing_where_the_pairing_fails_or_no_step_is_open(name):
    # the last operation's record lost: the pairs shift and the kinds of
    # the first pair (a kernel launch, a copy) disagree
    assert read(name, trace(DEV[:-1], HOST)) is None
    extra = DEV + [("stray", 160, 170)]
    assert read(name, trace(extra, HOST)) is None   # more ops than launches
    kinds = [("memset" if n == "Memcpy DtoD" else n, s, e)
             for n, s, e in DEV]
    assert read(name, trace(kinds, HOST)) is None   # a copy's launch
    parent = [h for h in HOST if h[0] not in ranges.STEPS]
    assert read(name, trace(DEV, parent)) is None   # a program with no step


def test_launches_without_a_record_at_the_windows_start_are_dropped():
    """A profiler that starts late keeps no device record of the window's
    first launches: the rest pair from the end."""
    got = ranges.attribute(trace(DEV[1:], HOST))
    assert [r for r, _ in got] == [
        "attn_core", "moe_router", "moe_expert_products", "moe_combine",
        "serve_step", None]
    rows = ranges.table(trace(DEV[1:], HOST))
    assert rows["attn_core"]["launches"] == 1
    assert rows["attn_core"]["device_s"] == pytest.approx(10e-6)


def test_idle_gaps_count_by_their_midpoint():
    # gaps: [50, 52] (mid 51, in), [54, 62] (58, in), [72, 80] (76, in),
    # [84, 92] (88, in), [96, 140] (mid 118: the harness's token read)
    t = trace(DEV, HOST, window_s=200e-6)
    assert read("step_idle_share.decode", t) == pytest.approx(
        100 * (2 + 8 + 8 + 8) / 200)
    assert read("step_idle_share.prefill", t) is None
    host = [(("prefill_step" if n == "serve_step" else n), s, e)
            for n, s, e in HOST]
    assert read("step_idle_share.prefill", trace(DEV, host,
                                                 window_s=200e-6)) == \
        pytest.approx(13.0)
    # [95, 150] straddles the step's end, its midpoint (122.5) past it
    dev = [("a", 0, 10), ("b", 90, 95), ("c", 150, 160)]
    host = [("serve_step", 0, 120)]
    assert read("step_idle_share.decode", trace(dev, host,
                                                window_s=1e-3)) == \
        pytest.approx(100 * 80 / 1000)


def test_the_frozen_names_are_the_programs():
    """The frozen list is the program's, and every range name a reader
    writes is in it."""
    import ast

    from conftest import BENCH
    from repro_torch import obs
    assert ranges.RANGES == obs.RANGES
    assert set(ranges.STEPS) == {obs.PREFILL_STEP, obs.SERVE_STEP}
    for name in ("attn_core_share.decode", "moe_share.decode",
                 "norm_rope_share.prefill", "step_idle_share.decode",
                 "step_idle_share.prefill"):
        tree = ast.parse((BENCH / "metrics" / f"{name}.py").read_text())
        read = next(n for n in tree.body
                    if isinstance(n, ast.FunctionDef) and n.name == "read")
        used = {c.value for c in ast.walk(read)
                if isinstance(c, ast.Constant) and isinstance(c.value, str)}
        assert used and used <= set(ranges.RANGES), (name, used)
