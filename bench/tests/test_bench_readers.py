"""Each per-layer reader against a hand-made trace: its arithmetic, and
nothing (not 0) where the trace holds nothing for it to read."""

import pytest

from benchlib import harness
from benchlib.trace import Trace

US = 1e6


def trace(device, *, window_s=1.0, steps=2, timed_s=1.0, counts=None,
          host=()):
    return Trace(window_s=window_s, steps=steps, device=list(device),
                 host=list(host), timed_s=timed_s, counts=counts or {})


def read(name, t):
    return harness.metric_reader(name)(t)


def test_busy_union_and_idle_share():
    t = trace([("gemm_a", 0, 0.2 * US), ("gemm_b", 0.1 * US, 0.3 * US),
               ("elementwise", 0.5 * US, 0.6 * US)])
    assert t.busy_s() == pytest.approx(0.4)
    for fam in ("prefill", "decode"):
        assert read(f"idle_share.{fam}", t) == pytest.approx(60.0)
        assert read(f"idle_share.{fam}", trace([])) is None


def test_mfu_is_required_work_over_the_untraced_steps():
    """The untraced steps' time is the denominator: the traced window,
    slowed by the profiler, is not."""
    c = {"flops": 989e12 * 0.25, "bytes": 1.0}      # 0.25 s at peak a step
    t = trace([("k", 0, 1)], window_s=2.5, timed_s=2.0, steps=4, counts=c)
    for fam in ("prefill", "decode"):
        assert read(f"mfu.{fam}", t) == pytest.approx(50.0)
    c = {"flops": 1.0, "bytes": 3.35e12 * 0.1}      # bound by bytes
    assert read("mfu.decode", trace([], timed_s=1.0, steps=5, counts=c)) \
        == pytest.approx(50.0)
    assert read("mfu.prefill", trace([])) is None
    assert read("mfu.decode", trace([], timed_s=0.0, counts=c)) is None


def test_attention_roofline():
    ev = [("void fedk::fa16::flash_attention_bf16_kernel<64>(Args)", 0,
           0.004 * US)] * 3 + [("nvjet_tst_gemm", 0, 0.5 * US)]
    t = trace(ev, counts={"attn_fwd_bound_s": 0.001})
    assert read("attn_roofline.prefill", t) == pytest.approx(25.0)
    assert read("attn_roofline.prefill", trace([("gemm", 0, 1)])) is None


def test_launches_leave_copies_out():
    ev = [("gemm", 0, 10), ("Memcpy DtoD", 10, 20), ("relu", 20, 30)] * 4
    assert read("launches_per_step.decode", trace(ev, steps=4)) == 2.0
    assert read("launches_per_step.decode", trace([], steps=4)) is None


def test_breakdown_names_gaps_by_the_host():
    dev = [("a", 0, 10), ("b", 30, 40), ("a", 100, 110)]
    host = [("step", 0, 120), ("aten::item", 45, 95)]
    bd = trace(dev, host=host).breakdown()
    assert bd["device_ops"][0] == ["a", 20 / US]
    assert bd["idle_gaps"] == [["aten::item", 60 / US], ["step", 20 / US]]
