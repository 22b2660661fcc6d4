"""The port's observability layer (``repro_torch.obs``, ``repro_torch.perf``)
against tests/test_obs.py's contract: zero cost when disabled, neutral when
enabled (a traced sync sweep, async sweep and serve give the untraced
records), a schema-valid Chrome trace with one track per trial lane on
both clocks, the metrics JSONL, and the span taxonomy of the engines.

Against the JAX package: the schema file is the reference's, the
reference's ``tools/trace_report.py`` reads the port's trace, and the
runner's fused-reduce counters (``reduce_fused_dispatches``,
``reduce_rows``, ``reduce_lanes``) equal the reference's on the same grid.
"""

import filecmp
import importlib.util
import json
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

from repro import obs as j_obs  # noqa: E402
from repro.experiments import TrialSpec as JTrialSpec  # noqa: E402
from repro.experiments import run_vectorized as j_run_vectorized  # noqa: E402
from repro.obs.export import validate_chrome_trace as j_validate  # noqa: E402
from repro_torch import obs, perf  # noqa: E402
from repro_torch.experiments import TrialSpec, serve  # noqa: E402
from repro_torch.experiments.runner import run_vectorized  # noqa: E402
from repro_torch.obs.export import (SCHEMA_PATH, VIRTUAL_PID,  # noqa: E402
                                    WALL_PID, chrome_trace, load_schema,
                                    read_metrics_jsonl, trace_paths_for,
                                    validate_chrome_trace,
                                    write_chrome_trace, write_metrics_jsonl)
from repro_torch.obs.metrics import MetricsRegistry  # noqa: E402
from repro_torch.obs.trace import NULL_SPAN  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_obs():
    """Every test starts and ends with both packages' tracing off and
    empty buffers."""
    for o in (obs, j_obs):
        o.disable()
        o.tracer.clear()
        o.registry.reset()
    yield
    for o in (obs, j_obs):
        o.disable()
        o.tracer.clear()
        o.registry.reset()


def tiny_spec(**kw):
    base = dict(dataset="emnist", aggregator="fedavg", seed=0,
                tuner="fedtune", m0=3, e0=1.0, rounds=3,
                target_accuracy=0.99, batch_size=5, eval_points=128)
    base.update(kw)
    return TrialSpec(**base)


def vec(specs):
    return run_vectorized(specs, device="cpu")


def assert_bitexact(plain, traced):
    for p, t in zip(plain, traced):
        assert p.spec.key() == t.spec.key()
        assert p.history_acc == t.history_acc
        assert p.history_m == t.history_m
        assert p.history_e == t.history_e
        assert p.final_accuracy == t.final_accuracy
        assert (p.final_m, p.final_e) == (t.final_m, t.final_e)
        np.testing.assert_allclose(p.cost, t.cost, rtol=0, atol=0)
        assert p.reached == t.reached and p.rounds == t.rounds
        assert p.dispatch_log == t.dispatch_log
        assert p.staleness_log == t.staleness_log
        assert p.local_steps == t.local_steps
        for a, b in zip(obs_leaves(p.params), obs_leaves(t.params)):
            assert torch.equal(a, b)


def obs_leaves(params):
    from repro_torch.tree import leaves
    return leaves(params)


# ---------------------------------------------------------------------------
# registry + perf shim
# ---------------------------------------------------------------------------

def test_registry_counters_gauges_histograms_series():
    reg = MetricsRegistry()
    reg.inc("a")
    reg.inc("a", 2.5)
    reg.gauge("g", 7)
    for v in range(10):
        reg.observe("h", v)
    reg.sample("s", 4, step=0, engine="sync")
    assert reg.counter_value("a") == 3.5
    assert reg.gauges()["g"] == 7.0
    h = reg.histogram_summary("h")
    assert h["count"] == 10 and h["min"] == 0 and h["max"] == 9
    assert h["mean"] == pytest.approx(4.5)
    assert reg.series("s") == [{"name": "s", "value": 4.0, "step": 0,
                               "engine": "sync"}]
    snap = reg.snapshot()
    assert snap["counters"]["a"] == 3.5 and snap["n_series"] == 1
    reg.reset()
    assert reg.counter_value("a") == 0.0 and reg.series() == []


def test_perf_shim_surface():
    perf.reset()
    with perf.timed("train"):
        time.sleep(0.002)
    perf.add("train", 1.0)
    perf.add("eval", 0.25)
    assert perf.seconds("train") > 1.0
    assert perf.calls("train") == 2
    assert perf.calls("missing") == 0 and perf.seconds("missing") == 0.0
    snap = perf.snapshot()
    assert set(snap) == {"train", "eval"} and snap["eval"] == 0.25
    assert perf.calls_snapshot() == {"train": 2, "eval": 1}
    perf.reset()
    assert perf.snapshot() == {}


def test_perf_and_obs_share_one_registry():
    with perf.timed("train"):
        pass
    assert obs.registry.phase_call_count("train") == 1
    perf.reset()     # resets the WHOLE registry, metrics included
    obs.registry.inc("x")
    perf.reset()
    assert obs.registry.counter_value("x") == 0.0


# ---------------------------------------------------------------------------
# zero-cost-when-disabled
# ---------------------------------------------------------------------------

def test_disabled_tracer_hands_out_the_shared_null_span():
    assert not obs.enabled()
    s = obs.span("anything", phase="train", trial="t", n=3)
    assert s is NULL_SPAN
    with s as inner:
        inner.set(more=1)      # attribute sink, no storage
    obs.record("x", virtual=(0, 1))
    obs.counter("c", 1)
    assert obs.tracer.spans == [] and obs.tracer.counters == []


def test_disabled_fast_path_is_cheap():
    t0 = time.perf_counter()
    for _ in range(100_000):
        with obs.span("s"):
            pass
    assert time.perf_counter() - t0 < 1.0


def test_enabled_spans_capture_dual_clocks():
    class FakeClock:
        now = 2.0
    obs.enable()
    clk = FakeClock()
    with obs.span("round", phase="round", trial="t0", round_idx=3,
                  clock=clk, n=5):
        clk.now = 6.0
    obs.disable()
    (sp,) = obs.tracer.spans
    assert sp.name == "round" and sp.trial == "t0" and sp.round_idx == 3
    assert sp.virtual_t0 == 2.0 and sp.virtual_t1 == 6.0
    assert sp.virtual_dur == 4.0 and sp.wall_dur >= 0.0
    assert sp.attrs == {"n": 5}


def test_enable_resets_previous_buffers():
    obs.enable()
    obs.record("a", virtual=(0, 1))
    obs.enable()               # default reset=True: fresh capture window
    assert obs.tracer.spans == []
    obs.enable(reset=False)
    obs.record("b", virtual=(0, 1))
    assert len(obs.tracer.spans) == 1


def test_nvtx_spans_record_without_a_cuda_build():
    """``nvtx=True`` opens an NVTX range per span where PyTorch has NVTX;
    on a CPU build the spans are still recorded, with no range."""
    obs.enable(nvtx=True)
    with obs.span("a", phase="train"):
        pass
    has_nvtx = obs.tracer._annotation_cls is not None
    obs.disable()
    assert [sp.name for sp in obs.tracer.spans] == ["a"]
    assert has_nvtx == torch.cuda.is_available()


# ---------------------------------------------------------------------------
# neutral when enabled: traced == untraced
# ---------------------------------------------------------------------------

def test_traced_sync_sweep_is_bit_exact():
    specs = [tiny_spec(seed=s, rounds=2, compression="int8" if s else None)
             for s in range(4)]
    plain = vec(specs)
    obs.enable()
    traced = vec(specs)
    obs.disable()
    assert_bitexact(plain, traced)
    assert len(obs.tracer.spans) > 0     # tracing actually happened
    assert obs.registry.counter_value("pack_dispatches") > 0


def test_traced_async_sweep_is_bit_exact_and_fills_staleness():
    specs = [tiny_spec(seed=s, mode="async", m0=2, rounds=3)
             for s in range(4)]
    plain = vec(specs)
    obs.enable()
    traced = vec(specs)
    obs.disable()
    assert_bitexact(plain, traced)
    stale = obs.registry.histogram_summary("staleness")
    assert stale["count"] == sum(len(t.staleness_log) for t in traced)
    assert obs.registry.counter_value("event_dispatched") > 0
    assert obs.registry.series("lanes_live")


def test_traced_serve_is_bit_exact_and_samples_occupancy():
    specs = ([tiny_spec(seed=s, rounds=1 + s % 2) for s in range(3)]
             + [tiny_spec(seed=3, rounds=2, mode="async"),
                tiny_spec(seed=4, rounds=1, mode="buffered")])
    plain = serve(specs, max_lanes=2, device="cpu")
    obs.enable()
    traced = serve(specs, max_lanes=2, device="cpu")
    obs.disable()
    assert_bitexact(plain, traced)
    names = [sp.name for sp in obs.tracer.spans]
    assert names.count("admit") == names.count("retire") == len(specs)
    occ = obs.registry.series("pool_occupancy")
    assert occ and all(0.0 < r["value"] <= 1.0 for r in occ)
    assert obs.registry.counter_value("trials_retired") == len(specs)


def test_reduce_counters_equal_the_reference():
    """The fused reduce's counters on the same grid: one dispatch per
    round, the same pow2-padded row counts and lane counts."""
    specs = [tiny_spec(seed=s, rounds=2, compression="int8" if s else None)
             for s in range(3)] + [tiny_spec(seed=3, aggregator="fednova",
                                             rounds=2)]
    obs.enable()
    vec(specs)
    obs.disable()
    j_obs.enable()
    j_run_vectorized([JTrialSpec(**s.to_dict()) for s in specs])
    j_obs.disable()
    for name in ("reduce_rows", "reduce_lanes"):
        got = [r["value"] for r in obs.registry.series(name)]
        assert got == [r["value"] for r in j_obs.registry.series(name)]
        assert len(got) == 2
    assert obs.registry.counter_value("reduce_fused_dispatches") == \
        j_obs.registry.counter_value("reduce_fused_dispatches") == 2


# ---------------------------------------------------------------------------
# chrome trace export + the schema
# ---------------------------------------------------------------------------

def _traced_sweep_trace(tmp_path):
    specs = [tiny_spec(seed=s, rounds=2) for s in range(2)]
    obs.enable()
    vec(specs)
    obs.disable()
    path = str(tmp_path / "sweep.trace.json")
    trace = write_chrome_trace(path)
    return specs, path, trace


def test_exported_trace_validates_and_has_per_lane_tracks(tmp_path):
    specs, path, trace = _traced_sweep_trace(tmp_path)
    assert validate_chrome_trace(trace) == []
    with open(path) as f:
        loaded = json.load(f)
    assert validate_chrome_trace(loaded) == []
    assert j_validate(loaded) == []               # the reference's validator
    names = {(ev["pid"], ev["args"]["name"])
             for ev in trace["traceEvents"]
             if ev["ph"] == "M" and ev["name"] == "thread_name"}
    for spec in specs:
        for pid in (WALL_PID, VIRTUAL_PID):
            assert any(p == pid and spec.key() in n for p, n in names), \
                (pid, spec.key())
    virt = [ev for ev in trace["traceEvents"]
            if ev["ph"] == "X" and ev["pid"] == VIRTUAL_PID]
    assert {ev["name"] for ev in virt} >= {"round"}
    assert any(ev["ph"] == "C" and ev["name"] == "t_sim"
               for ev in trace["traceEvents"])


def test_schema_is_the_reference_schema_and_catches_breakage():
    assert filecmp.cmp(SCHEMA_PATH, os.path.join(
        REPO, "src", "repro", "obs", "trace_schema.json"), shallow=False)
    schema = load_schema()
    ok = {"traceEvents": [
        {"ph": "X", "pid": 1, "tid": 0, "name": "a", "ts": 0.0,
         "dur": 1.0, "args": {}},
        {"ph": "X", "pid": 1, "tid": 0, "name": "b", "ts": 2.0,
         "dur": 1.0, "args": {}},
    ]}
    assert validate_chrome_trace(ok, schema) == []
    assert validate_chrome_trace({}, schema)
    missing_pid = {"traceEvents": [
        {"ph": "X", "tid": 0, "name": "a", "ts": 0.0, "dur": 1.0,
         "args": {}}]}
    assert any("missing" in e for e in
               validate_chrome_trace(missing_pid, schema))
    unknown_ph = {"traceEvents": [
        {"ph": "Z", "pid": 1, "tid": 0, "name": "a", "args": {}}]}
    assert any("ph" in e for e in validate_chrome_trace(unknown_ph, schema))
    backwards = {"traceEvents": [
        {"ph": "X", "pid": 1, "tid": 0, "name": "a", "ts": 5.0,
         "dur": 1.0, "args": {}},
        {"ph": "X", "pid": 1, "tid": 0, "name": "b", "ts": 1.0,
         "dur": 1.0, "args": {}}]}
    assert any("track" in e for e in
               validate_chrome_trace(backwards, schema))
    two_tracks = {"traceEvents": [
        {"ph": "X", "pid": 1, "tid": 0, "name": "a", "ts": 5.0,
         "dur": 1.0, "args": {}},
        {"ph": "X", "pid": 1, "tid": 1, "name": "b", "ts": 1.0,
         "dur": 1.0, "args": {}}]}
    assert validate_chrome_trace(two_tracks, schema) == []
    negative = {"traceEvents": [
        {"ph": "X", "pid": 1, "tid": 0, "name": "a", "ts": 0.0,
         "dur": -1.0, "args": {}}]}
    assert any("negative" in e for e in
               validate_chrome_trace(negative, schema))


def test_every_track_ts_is_monotonic_in_export(tmp_path):
    _specs, _path, trace = _traced_sweep_trace(tmp_path)
    last = {}
    for ev in trace["traceEvents"]:
        if ev["ph"] == "M":
            continue
        track = (ev["pid"], ev["tid"])
        assert ev["ts"] >= last.get(track, -1.0)
        last[track] = ev["ts"]


# ---------------------------------------------------------------------------
# metrics JSONL + path derivation
# ---------------------------------------------------------------------------

def test_metrics_jsonl_round_trip(tmp_path):
    obs.enable()
    obs.registry.sample("lanes_live", 4, step=0, engine="sync")
    obs.registry.inc("pack_steps_real", 30)
    obs.registry.inc("pack_steps_padded", 40)
    obs.registry.observe("staleness", 2)
    with perf.timed("train"):
        pass
    obs.disable()
    path = str(tmp_path / "m.jsonl")
    n = write_metrics_jsonl(path)
    rows = read_metrics_jsonl(path)
    assert len(rows) == n
    by_kind = {}
    for r in rows:
        by_kind.setdefault(r["kind"], []).append(r)
    assert {"kind": "sample", "name": "lanes_live", "value": 4.0,
            "step": 0, "engine": "sync"} in by_kind["sample"]
    counters = {r["name"]: r["value"] for r in by_kind["counter"]}
    assert counters["pack_steps_real"] == 30.0
    (h,) = by_kind["histogram"]
    assert h["name"] == "staleness" and h["count"] == 1
    (p,) = by_kind["phase"]
    assert p["name"] == "train" and p["calls"] == 1


def test_trace_paths_derive_from_the_store():
    assert trace_paths_for("runs/sweep.jsonl") == (
        "runs/sweep.trace.json", "runs/sweep.metrics.jsonl")
    assert trace_paths_for("runs/sweep.jsonl", "x/t.trace.json") == (
        "x/t.trace.json", "x/t.metrics.jsonl")
    assert trace_paths_for("out", "t.json") == ("t.json", "t.metrics.jsonl")


# ---------------------------------------------------------------------------
# the reference's trace_report reads the port's trace
# ---------------------------------------------------------------------------

def _load_trace_report():
    path = os.path.join(REPO, "tools", "trace_report.py")
    spec = importlib.util.spec_from_file_location("trace_report", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_trace_report_reads_a_traced_port_sweep(tmp_path, capsys):
    specs = [tiny_spec(seed=s, rounds=2) for s in range(2)]
    obs.enable()
    vec(specs)
    obs.disable()
    trace_path, metrics_path = trace_paths_for(str(tmp_path / "s.jsonl"))
    write_chrome_trace(trace_path)
    write_metrics_jsonl(metrics_path)

    tr = _load_trace_report()
    rep = tr.report(trace_path, metrics_path)
    assert rep["valid"] and not rep["errors"]
    assert len(rep["lanes"]) == len(specs)
    for lane in rep["lanes"]:
        assert 0.0 < lane["occupancy"] <= 1.0
        assert lane["t_sim_s"] > 0
    assert rep["phases"]["train"]["calls"] > 0
    met = rep["metrics"]
    assert met["mean_lanes_live"] == pytest.approx(2.0)
    assert 0.0 <= met["padding_waste"] < 1.0
    assert met["phase_calls"]["train"] > 0
    assert tr.main([trace_path, "--metrics", metrics_path]) == 0
    out = capsys.readouterr().out
    assert "wall-clock phases" in out and "virtual-clock lanes" in out


def test_trace_report_rejects_an_invalid_trace(tmp_path, capsys):
    bad = str(tmp_path / "bad.trace.json")
    with open(bad, "w") as f:
        json.dump({"traceEvents": [
            {"ph": "X", "tid": 0, "name": "a", "ts": 0.0, "dur": 1.0,
             "args": {}}]}, f)
    tr = _load_trace_report()
    assert tr.main([bad]) == 2
    assert "SCHEMA VIOLATION" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# engine-level span taxonomy
# ---------------------------------------------------------------------------

def test_sync_sweep_emits_the_macro_and_round_span_taxonomy():
    specs = [tiny_spec(rounds=2, preference=p)
             for p in ((1.0, 0.0, 0.0, 0.0), (0.25, 0.25, 0.25, 0.25))]
    obs.enable()
    vec(specs)
    obs.disable()
    names = {sp.name for sp in obs.tracer.spans}
    assert {"PLAN", "PACK", "TRAIN", "APPLY", "REDUCE", "EVAL",
            "plan_sync_round", "account_sync_round", "round",
            "eval_stacked"} <= names
    rounds = [sp for sp in obs.tracer.spans if sp.name == "round"]
    assert all(sp.virtual_dur is not None and sp.virtual_dur > 0
               for sp in rounds)
    assert {sp.trial for sp in rounds} == {s.key() for s in specs}


def test_event_sweep_emits_collect_pack_apply_and_inflight_spans():
    specs = [tiny_spec(seed=s, mode="async", m0=2, rounds=2)
             for s in range(2)]
    obs.enable()
    vec(specs)
    obs.disable()
    names = {sp.name for sp in obs.tracer.spans}
    assert {"COLLECT", "PACK", "APPLY", "EVAL", "plan_event", "apply_event",
            "finish_event_round", "inflight", "agg_window"} <= names
    infl = [sp for sp in obs.tracer.spans if sp.name == "inflight"]
    assert all(sp.virtual_dur > 0 and sp.wall_dur == 0.0 for sp in infl)


def test_virtual_span_a_rounding_error_below_zero_exports_at_zero():
    """An in-flight window recovered as ``arrival - comp - trans`` can
    start a rounding error before the virtual clock's 0; it is exported at
    0 so the trace stays valid against the schema."""
    comp, trans = 0.3, 0.4
    arrival = 0.0 + comp + trans
    assert arrival - comp - trans < 0.0          # the rounding in question
    obs.enable()
    obs.record("inflight", phase="inflight", trial="t0",
               virtual=(arrival - comp - trans, arrival))
    obs.disable()
    trace = chrome_trace()
    virt = [ev for ev in trace["traceEvents"]
            if ev["ph"] == "X" and ev["pid"] == VIRTUAL_PID]
    assert [ev["ts"] for ev in virt] == [0.0]
    assert virt[0]["dur"] == pytest.approx(arrival * 1e3)
    assert validate_chrome_trace(trace) == []
