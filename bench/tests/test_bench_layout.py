"""The benchmark is driven by data: every cell, configuration and metric of
``BENCHMARK.json`` is found by its name, and a cell, a configuration and a
per-layer metric added as new files alone are found and run."""

import json
import re
import shutil
import time

import pytest

from conftest import BENCH, SMALL_DENSE, SMALL_TRAFFIC, cells

SPEC = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_spec_keys_and_names():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["bench"]
    assert SPEC["command"] == ["python3", "bench/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in SPEC[k]]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25
               for m in SPEC["end_to_end"])
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and m["better"] in ("lower", "higher")
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
    for w in SPEC["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("cell", cells())
def test_cell_found_by_name(cell):
    from benchlib import harness
    w = next(x for x in SPEC["workloads"] if x["name"] == cell)
    wl = harness.workload(cell)
    assert wl["config"] == w["config"] and wl["why"] == w["why"]
    assert wl["chips"] == w["chips"]
    conf = next(c for c in SPEC["configs"] if c["name"] == w["config"])
    assert (BENCH.parent / conf["file"]).is_file()
    assert harness.config(w["config"])["source"] == conf["source"]
    harness.entry_class(wl["entry"])
    mine = harness.cell_metrics(SPEC, cell)
    assert any(m["name"] == "setup_s" for m in mine["end_to_end"])
    assert len(mine["end_to_end"]) >= 2 and mine["per_layer"]
    for m in mine["per_layer"]:
        assert callable(harness.metric_reader(m["name"]))
    assert set(wl["limits"]) == {"token_gap", "logit_err", "cache_err"}


def test_every_config_is_used_and_matches_the_program():
    from benchlib import harness
    from repro_torch.configs import get_config
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    for name in used:
        mine = harness.program_config(harness.config(name)["model"])
        prog = get_config(name)
        for f in ("n_layers", "d_model", "n_heads", "n_kv_heads",
                  "head_dim", "d_ff", "vocab_size", "qkv_bias",
                  "rope_theta", "norm_eps", "tie_embeddings", "act",
                  "moe", "layers"):
            assert getattr(mine, f) == getattr(prog, f), (name, f)


def test_a_cell_added_as_new_files_is_found_and_runs(tmp_path):
    """A copy of the benchmark gains a configuration, a cell and a
    per-layer metric as new files, and ``BENCHMARK.json`` new entries;
    no file that was there is edited."""
    from benchlib import harness
    bench = tmp_path / "bench"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    conf = json.loads((BENCH / "configs" / "qwen2-7b.json").read_text())
    conf["name"] = conf["model"]["name"] = "tiny-dense"
    conf["model"].update(SMALL_DENSE)
    (bench / "configs" / "tiny-dense.json").write_text(json.dumps(conf))
    wl = json.loads((BENCH / "workloads" / "qwen2-7b.prefill-2k.json")
                    .read_text())
    wl.update(config="tiny-dense", trace_steps=2,
              traffic=dict(wl["traffic"], **SMALL_TRAFFIC["prefill"]),
              limits={"token_gap": 1.0, "logit_err": 1.0, "cache_err": 1.0})
    (bench / "workloads" / "tiny-dense.short.json").write_text(
        json.dumps(wl))
    (bench / "metrics" / "steps_seen.prefill.py").write_text(
        "def read(t):\n    return float(t.steps)\n")
    spec = json.loads(json.dumps(SPEC))
    spec["configs"].append({"name": "tiny-dense", "source": "test",
                            "file": "bench/configs/tiny-dense.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "tiny-dense.short",
                              "config": "tiny-dense", "traffic": "short",
                              "chips": 1, "why": "test"})
    for m in spec["end_to_end"]:
        if m["name"] == "prefill_tokens_per_s":
            m["workloads"].append("tiny-dense.short")
    spec["per_layer"].append({"name": "steps_seen.prefill", "unit": "steps",
                              "better": "higher", "source": "host_clock",
                              "layer": "test",
                              "moves": "prefill_tokens_per_s",
                              "workloads": ["tiny-dense.short"]})
    out = harness.run_cell("tiny-dense.short", 5, 0.2, False, "cpu",
                           time.perf_counter(), bench=bench, spec=spec)
    assert out["correct"]
    assert set(out["metrics"]) == {"prefill_tokens_per_s", "setup_s"}
    out = harness.run_cell("tiny-dense.short", 6, 0.2, True, "cpu",
                           time.perf_counter(), bench=bench, spec=spec)
    assert out["metrics"]["steps_seen.prefill"]["value"] == 2.0
    assert list(out)[-1] == "checks"
    for p, data in before.items():
        assert p.read_bytes() == data, p
