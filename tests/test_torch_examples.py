"""The port's launchers of the four examples against the examples
themselves: ``launch/paper_tables.py``, ``quickstart.py``,
``preference_sweep.py`` and ``heterogeneous_fl.py`` against
``examples/*.py`` loaded by path, on the same initial params.

``torch`` cannot reproduce ``jax.random`` (ROADMAP.md section 3, departure
3): each example draws its init from ``model.init(PRNGKey(seed))``, and the
launcher is handed the same tree as numpy through its ``init_params`` hook.
Both sides are cut alike where the example has no flag for it: the
examples' ``FLConfig`` to 3 rounds, ``preference_sweep``'s ``PREFS`` to two
preferences, Table 6 to two aggregators (``build_sweep`` wrapped).  Then:

  * ``build_sweep`` gives the example's trial keys and specs;
  * a table's store records, but for the wall-clock field, and its rendered
    ``paper_table`` are equal;
  * a store the example wrote resumes in the launcher, and the reverse;
  * the FLServer launchers give the example's (M, E) per round, costs,
    accuracies, virtual clocks and FedTune traces, and print the example's
    lines;
  * ``--pack sharded`` and ``--client-exec sharded`` in one process print
    the fallback and give the batched run's records.
"""

import dataclasses
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402

from repro.experiments.runner import build_server as j_build_server  # noqa: E402
from repro.experiments import TrialSpec as JTrialSpec  # noqa: E402
from repro.federated import FLConfig as JFLConfig  # noqa: E402
from repro.federated import FLServer as JFLServer  # noqa: E402
from repro_torch.federated import FLConfig  # noqa: E402
from repro_torch.launch import heterogeneous_fl  # noqa: E402
from repro_torch.launch import paper_tables  # noqa: E402
from repro_torch.launch import preference_sweep  # noqa: E402
from repro_torch.launch import quickstart  # noqa: E402

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
ROUNDS = 3
PORT = {"quickstart": quickstart, "preference_sweep": preference_sweep,
        "heterogeneous_fl": heterogeneous_fl, "paper_tables": paper_tables}


def example(name):
    """``examples/<name>.py`` as a fresh module (its ``main`` not run)."""
    spec = importlib.util.spec_from_file_location(f"example_{name}",
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference_init(spec):
    """The reference sweep's initial params for ``spec``, as numpy."""
    srv = j_build_server(JTrialSpec(**spec.to_dict()))
    return jax.tree.map(np.asarray,
                        srv.model.init(jax.random.PRNGKey(spec.seed)))


def cut_rounds(cls):
    """``cls`` (either package's FLConfig) with ``max_rounds`` cut."""
    def make(*a, **kw):
        return dataclasses.replace(cls(*a, **kw), max_rounds=ROUNDS)
    return make


def without_wall(records):
    return [{k: v for k, v in r.items() if k != "wall"} for r in records]


def table_of(text):
    """The rendered ``paper_table`` in a launcher's output: everything from
    its title on."""
    return text[text.index("## Paper Table"):].strip()


# ---------------------------------------------------------------------------
# paper_tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("table,prefs", [(4, "0,1,4,14"), (4, "all"),
                                         (5, "0,1,4,14"), (6, "0,1,4,14")])
def test_build_sweep_gives_the_examples_trials(table, prefs):
    want = example("paper_tables").build_sweep(table, prefs, 2, 15, 0.5)
    got = paper_tables.build_sweep(table, prefs, 2, 15, 0.5)
    w, g = want.expand(), got.expand()
    assert [s.key() for s in g] == [s.key() for s in w]
    assert [s.to_dict() for s in g] == [s.to_dict() for s in w]
    # FedTune trials per (preference, aggregator, dataset) and one fixed
    # baseline per (aggregator, dataset), for each of the 2 seeds
    assert len(g) == {(4, "0,1,4,14"): 10, (4, "all"): 32,
                      (5, "0,1,4,14"): 12, (6, "0,1,4,14"): 20}[(table, prefs)]
    with pytest.raises(ValueError, match="valid tables"):
        paper_tables.build_sweep(7, prefs, 1, 15, 0.5)


def two_aggregators(build):
    """``build_sweep`` with Table 6 cut to FedAvg and FedYogi (the adaptive
    aggregator with the square root, ROADMAP.md departure 2)."""
    def cut(table, *a):
        sweep = build(table, *a)
        if table == 6:
            sweep = dataclasses.replace(sweep,
                                        aggregators=("fedavg", "fedyogi"))
        return sweep
    return cut


def run_example_table(monkeypatch, capsys, table, out, pack="batched"):
    ex = example("paper_tables")
    monkeypatch.setattr(ex, "build_sweep", two_aggregators(ex.build_sweep))
    monkeypatch.setattr("sys.argv", [
        "paper_tables.py", "--table", str(table), "--rounds", str(ROUNDS),
        "--out", str(out), "--pack", pack])
    ex.main()
    return capsys.readouterr().out


def run_port_table(monkeypatch, capsys, table, out, pack="batched"):
    monkeypatch.setattr(paper_tables, "build_sweep",
                        two_aggregators(paper_tables.build_sweep))
    res = paper_tables.main(["--table", str(table), "--rounds", str(ROUNDS),
                             "--out", str(out), "--pack", pack,
                             "--device", "cpu"], init_params=reference_init)
    return res, capsys.readouterr().out


def load(path):
    """The store's records by trial key, but for the wall-clock field."""
    recs = [json.loads(ln) for ln in Path(path).read_text().splitlines()]
    return sorted(without_wall(recs), key=lambda r: r["key"])


@pytest.mark.parametrize("table", [5, 6])
def test_paper_table_matches_the_example(table, tmp_path, monkeypatch,
                                         capsys):
    """The whole table from scratch in both packages; then the example's
    store, cut to its first two trials, resumes in the launcher, and the
    launcher's store, cut alike, resumes in the example."""
    ref, got = tmp_path / "ref.jsonl", tmp_path / "port.jsonl"
    ref_out = run_example_table(monkeypatch, capsys, table, ref)
    res, port_out = run_port_table(monkeypatch, capsys, table, got)
    n = {5: 6, 6: 4}[table]
    assert f"table {table}: {n} trials (0 already done)" in port_out
    assert len(res) == n and all(r.rounds == ROUNDS for r in res)
    assert load(got) == load(ref)
    assert table_of(port_out) == table_of(ref_out)
    assert "| — |" not in table_of(port_out)     # every cell filled

    for src, dst, run in ((ref, "ref_then_port.jsonl", run_port_table),
                          (got, "port_then_ref.jsonl", run_example_table)):
        dst = tmp_path / dst
        dst.write_text("".join(Path(src).read_text().splitlines(True)[:2]))
        out = run(monkeypatch, capsys, table, dst)
        out = out[1] if isinstance(out, tuple) else out
        assert f"table {table}: {n} trials (2 already done)" in out
        assert f"ran {n - 2} trial(s)" in out
        assert load(dst) == load(ref)
        assert table_of(out) == table_of(ref_out)


def test_pack_sharded_in_one_process_falls_back(tmp_path, monkeypatch,
                                                capsys):
    batched, _ = run_port_table(monkeypatch, capsys, 5,
                                tmp_path / "b.jsonl")
    sharded, out = run_port_table(monkeypatch, capsys, 5,
                                  tmp_path / "s.jsonl", pack="sharded")
    assert "falling back to batched packing" in out
    assert [r.engine for r in sharded] == ["vectorized/batched"] * 6
    assert load(tmp_path / "s.jsonl") == load(tmp_path / "b.jsonl")


# ---------------------------------------------------------------------------
# the FLServer launchers
# ---------------------------------------------------------------------------

def record_runs(monkeypatch, mod, server_cls):
    """Every server ``mod`` builds, with its result, in order."""
    runs = []

    class Recording(server_cls):
        def run(self, params=None):
            res = super().run(params)
            runs.append((self, res))
            return res
    monkeypatch.setattr(mod, "FLServer", Recording)
    return runs


def records(srv, res):
    hist = [(h.m, h.e, h.accuracy, h.cost.as_tuple(), h.sim_time,
             h.n_updates) for h in res.history]
    trace = [(t["m_next"], t["e_next"]) for t in srv.tuner.trace]
    return (hist, res.total_cost.as_tuple(), res.final_accuracy,
            res.final_m, res.final_e, res.reached_target, res.sim_time,
            trace)


ARGV = {"quickstart": [], "preference_sweep": [],
        "heterogeneous_fl": ["--rounds", str(ROUNDS)]}


@pytest.mark.parametrize("name", ["quickstart", "preference_sweep",
                                  "heterogeneous_fl"])
def test_launcher_matches_the_example(name, monkeypatch, capsys):
    ex, port = example(name), PORT[name]
    for mod, cfg in ((ex, JFLConfig), (port, FLConfig)):
        monkeypatch.setattr(mod, "FLConfig", cut_rounds(cfg))
        if name == "preference_sweep":
            monkeypatch.setattr(mod, "PREFS", {
                k: mod.PREFS[k] for k in ("CompT-only (a=1)", "balanced")})
    want = record_runs(monkeypatch, ex, JFLServer)
    got = record_runs(monkeypatch, port, port.FLServer)
    monkeypatch.setattr("sys.argv", [f"{name}.py"] + ARGV[name])
    ex.main()
    ref_out = capsys.readouterr().out
    init = jax.tree.map(np.asarray, want[0][0].model.init(
        jax.random.PRNGKey(0)))
    port.main(ARGV[name] + ["--device", "cpu"], init_params=init)
    port_out = capsys.readouterr().out
    assert len(got) == len(want) == {"quickstart": 1, "preference_sweep": 2,
                                     "heterogeneous_fl": 3}[name]
    for (ws, wr), (gs, gr) in zip(want, got):
        assert records(gs, gr) == records(ws, wr)
        assert gr.rounds == ROUNDS
        assert gs.tuner.trace, "FedTune took no decision in the cut run"
    assert port_out == ref_out
    if name == "heterogeneous_fl":
        assert [s.runtime_config.mode for s, _ in got] == \
            ["sync", "async", "buffered"]


def test_client_exec_sharded_in_one_process_falls_back(monkeypatch, capsys):
    argv = ["--rounds", str(ROUNDS), "--device", "cpu", "--client-exec"]
    batched = heterogeneous_fl.main(argv + ["batched"])
    capsys.readouterr()
    sharded = heterogeneous_fl.main(argv + ["sharded"])
    out = capsys.readouterr().out
    assert "sharded execution needs a process group" in out
    for mode in ("sync", "async", "buffered"):
        b, s = batched[mode], sharded[mode]
        assert [(h.m, h.e, h.accuracy, h.cost.as_tuple()) for h in
                s.history] == [(h.m, h.e, h.accuracy, h.cost.as_tuple())
                               for h in b.history]


def test_launchers_default_to_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name, argv in (("quickstart", []), ("preference_sweep", []),
                       ("heterogeneous_fl", []),
                       ("paper_tables", ["--out",
                                         str(tmp_path / "t.jsonl")])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            PORT[name].main(argv)
