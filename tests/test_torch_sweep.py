"""The port's sweep engine: cohort packing, packed sync rounds, the
merged-queue async/buffered engine, the grid, the store and the sweep CLI.

Inside the port, a vectorized sweep must give every trial exactly what its
standalone ``FLServer.run()`` gives, as ``assert_trial_parity`` in
tests/test_experiments.py holds the reference to: accuracies, (M, E)
trajectories, cost totals, dispatch and staleness logs, all equal.  Params
are not compared bit for bit between a packed lane and a standalone run: a
batched product does not give each lane the bits of a single product.

Against the JAX package, on the same numpy inputs:
  * ``TrialSpec.key()`` and ``SweepSpec.expand()`` give the same strings;
  * ``compress_delta_lanes`` is bitwise per lane;
  * ``batched_local_train`` gives the same ``n_steps``, with params within
    atol=1e-4 of the reference's (the tolerance of one ``local_train``
    against the reference, tests/test_torch_federated.py: a 148-step
    client drifts 4e-5 there) and within atol=1e-5 of the port's own
    sequential ``local_train``, as tests/test_runtime.py holds the
    reference's batched path to its sequential one;
  * a T=4 reduced vectorized sweep from the reference's initial params
    gives the same (M, E), costs and logs, accuracies within 0.01, and
    final params within atol=1e-5 (FedAvg, FedAsync) or 2e-3 (int8 lanes:
    a last-bit difference before the round trip can move a value by one
    quantisation step, max|delta|/127 of its leaf) of the reference's
    standalone run.  FedAdam's params are not compared: its normalised
    server step (tau = 1e-3) grows a 1e-6 difference about 60x a round.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.experiments import SweepSpec as JSweepSpec  # noqa: E402
from repro.experiments import TrialSpec as JTrialSpec  # noqa: E402
from repro.experiments import ResultStore as JResultStore  # noqa: E402
from repro.experiments import run_sweep as j_run_sweep  # noqa: E402
from repro.experiments import run_vectorized as j_run_vectorized  # noqa: E402
from repro.experiments.grid import parse_preferences as j_parse_prefs  # noqa: E402
from repro.experiments.runner import build_server as j_build_server  # noqa: E402
from repro.federated import compression as jcomp  # noqa: E402
from repro.launch.sweep import smoke_grid as j_smoke_grid  # noqa: E402
from repro.runtime.batched import batched_local_train as j_batched  # noqa: E402
from repro_torch.experiments import (SweepSpec, TrialSpec,  # noqa: E402
                                     parse_preferences, run_sweep,
                                     run_trial, run_vectorized)
from repro_torch.experiments import runner as t_runner  # noqa: E402
from repro_torch.experiments.grid import spec_from_dict  # noqa: E402
from repro_torch.federated import compression as tcomp  # noqa: E402
from repro_torch.federated.client import local_train  # noqa: E402
from repro_torch.federated.evaluation import (Evaluator,  # noqa: E402
                                              StackedEvaluator,
                                              evaluate_stacked)
from repro_torch.launch import sweep as t_sweep  # noqa: E402
from repro_torch.launch.mesh import make_clients_mesh  # noqa: E402
from repro_torch.runtime import RuntimeConfig  # noqa: E402
from repro_torch.runtime.batched import batched_local_train  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402
from repro_torch.weights import params_from_numpy  # noqa: E402


def tiny_spec(**kw):
    base = dict(dataset="emnist", aggregator="fedavg", seed=0,
                tuner="fedtune", m0=3, e0=1.0, rounds=3,
                target_accuracy=0.99, batch_size=5, eval_points=128)
    base.update(kw)
    return TrialSpec(**base)


def assert_trial_parity(base, vec):
    """tests/test_experiments.py's contract: every record that comes from
    counts, decisions and numpy clocks is equal."""
    assert base.history_acc == vec.history_acc
    assert base.history_m == vec.history_m
    assert base.history_e == vec.history_e
    assert base.final_accuracy == vec.final_accuracy
    assert (base.final_m, base.final_e) == (vec.final_m, vec.final_e)
    np.testing.assert_allclose(base.cost, vec.cost, rtol=0, atol=0)
    assert base.reached == vec.reached
    assert base.rounds == vec.rounds
    assert base.dispatch_log == vec.dispatch_log
    assert base.staleness_log == vec.staleness_log


def _reference_init(spec):
    """The reference runner's initial params for ``spec``, as numpy."""
    srv = j_build_server(JTrialSpec(**spec.to_dict()))
    return jax.tree.map(np.asarray,
                        srv.model.init(jax.random.PRNGKey(spec.seed)))


# ---------------------------------------------------------------------------
# grid
# ---------------------------------------------------------------------------

def test_spec_keys_and_expansion_match_the_reference():
    axes = dict(datasets=("emnist", "cifar100", "speech_command"),
                aggregators=("fedavg", "fedadam", "fednova"),
                seeds=(0, 1), tuners=("fedtune", "fixed"),
                inits=((4, 1.0), (5, 2.5)),
                modes=("sync", "async", "buffered"),
                hets=("homogeneous", "stragglers"),
                compressions=(None, "int8"))
    base = dict(rounds=7, target_accuracy=0.8, batch_size=10, prox_mu=0.01,
                failure_rate=0.1, churn="5:0.2", reduced=False, lr=0.05)
    got = SweepSpec(preferences=parse_preferences("0,3,14"),
                    base=TrialSpec(**base), **axes).expand()
    want = JSweepSpec(preferences=j_parse_prefs("0,3,14"),
                      base=JTrialSpec(**base), **axes).expand()
    assert len(got) == len(want) > 500
    assert [s.key() for s in got] == [s.key() for s in want]
    assert [s.baseline_key() for s in got] == \
        [s.baseline_key() for s in want]
    assert [s.to_dict() for s in got] == [s.to_dict() for s in want]
    assert spec_from_dict(want[17].to_dict()) == got[17]
    for bad in (dict(aggregator="fedsgd"), dict(mode="psychic"),
                dict(client_exec="warp"), dict(het="lunar")):
        with pytest.raises(ValueError):
            tiny_spec(**bad).validate()


# ---------------------------------------------------------------------------
# the packing modules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_compress_delta_lanes_bitwise_per_lane(masked):
    rng = np.random.default_rng(5)
    m = 6
    shapes = {"layers": [{"b": (48,), "w": (24, 48)},
                         {"b": (8,), "w": (48, 8)}]}

    def draw(scale):
        return {"layers": [{k: (rng.standard_normal((m,) + s) * scale)
                            .astype(np.float32) for k, s in lay.items()}
                           for lay in shapes["layers"]]}
    g = draw(0.1)
    c = jax.tree.map(lambda a, d: a + d, g, draw(0.01))
    c["layers"][1]["b"][2] = g["layers"][1]["b"][2]   # an all-zero delta
    enabled = np.array([True, False, True, True, False, True]) if masked \
        else None
    assert (tcomp.lane_mask([None, "int8"]) == jcomp.lane_mask(
        [None, "int8"])).all()
    assert tcomp.lane_mask(["none", None]) is None
    want = jcomp.compress_delta_lanes(jax.tree.map(jnp.asarray, g),
                                      jax.tree.map(jnp.asarray, c), enabled)
    tg, tc = params_from_numpy(g, "cpu"), params_from_numpy(c, "cpu")
    got = tcomp.compress_delta_lanes(tg, tc, enabled)
    for a, b in zip(leaves(got), jax.tree.leaves(want)):
        assert np.array_equal(a.numpy(), np.asarray(b))
    for i in range(m):                 # lane i == the per-tree round trip
        one = tcomp.compress_delta(
            [t[i] for t in leaves(tg)], [t[i] for t in leaves(tc)])
        for a, b in zip(leaves(got), one):
            if enabled is None or enabled[i]:
                assert torch.equal(a[i], b)


def test_stacked_evaluator_lane_equals_evaluator():
    srv = t_runner.build_server(tiny_spec(), "cpu")
    params = [srv.model.init(s, "cpu") for s in range(5)]
    single = Evaluator(srv.model, srv.dataset, 128, "cpu")
    expect = [single.evaluate(p) for p in params]
    stacked = StackedEvaluator(srv.model, srv.dataset, 128, "cpu")
    assert stacked.evaluate(params) == expect
    assert stacked.evaluate(params, pad_to=8) == expect
    assert stacked.evaluate(params[:1]) == expect[:1]
    items = [(srv.model, srv.dataset, 128, p) for p in params]
    assert evaluate_stacked(items, pad_pow2=True) == expect
    # one process: the mesh has one rank, which evaluates every lane
    one_rank = make_clients_mesh()
    assert one_rank.size == 1
    assert stacked.evaluate(params, mesh=one_rank) == expect


def test_batched_local_train_matches_reference_and_sequential():
    srv = t_runner.build_server(tiny_spec(), "cpu")
    p0 = _reference_init(tiny_spec())
    jsrv = j_build_server(JTrialSpec(**tiny_spec().to_dict()))
    cids = [0, 3, 7, 11, 15, 21]
    data = [srv.dataset.client_data(c) for c in cids]
    kw = dict(passes=2.0, batch_size=4)
    want = j_batched(jsrv.model, jax.tree.map(jnp.asarray, p0), data,
                     optimizer=jsrv.optimizer,
                     rng=np.random.default_rng(42), client_ids=cids, **kw)
    tp = params_from_numpy(p0, "cpu")
    got = batched_local_train(srv.model, tp, data, optimizer=srv.optimizer,
                              rng=np.random.default_rng(42),
                              client_ids=cids, **kw)
    rng = np.random.default_rng(42)
    seq = [local_train(srv.model, tp, x, y, optimizer=srv.optimizer,
                       rng=rng, **kw) for x, y in data]
    assert len({u.n_steps for u in got}) > 2       # several step buckets
    for g, w, s, cid in zip(got, want, seq, cids):
        assert g.client_id == w.client_id == cid
        assert g.n_steps == w.n_steps == s.n_steps
        assert g.last_loss == pytest.approx(s.last_loss, rel=1e-5)
        for a, b, c in zip(leaves(g.params), jax.tree.leaves(w.params),
                           leaves(s.params)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)
            np.testing.assert_allclose(a.numpy(), c.numpy(), atol=1e-5)


def test_batched_client_exec_matches_sequential_run(capsys):
    """``client_exec="batched"`` (and the legacy ``batched=True``) runs a
    sync round's clients as one packed cohort: the same decisions, costs
    and rng stream as the sequential loop, accuracies within 1e-5 (as
    tests/test_runtime.py holds the reference)."""
    spec = tiny_spec(rounds=3, compression="int8")
    runs = {}
    for name, rt in (("seq", RuntimeConfig()),
                     ("bat", RuntimeConfig(client_exec="batched")),
                     ("alias", RuntimeConfig(batched=True))):
        srv = t_runner.build_server(spec, "cpu")
        srv.runtime_config = rt
        runs[name] = srv.run(srv.model.init(0, "cpu"))
    seq = runs["seq"]
    for bat in (runs["bat"], runs["alias"]):
        assert [(h.m, h.e) for h in bat.history] == \
            [(h.m, h.e) for h in seq.history]
        assert bat.total_cost.as_tuple() == seq.total_cost.as_tuple()
        np.testing.assert_allclose([h.accuracy for h in bat.history],
                                   [h.accuracy for h in seq.history],
                                   atol=1e-5)
    srv = t_runner.build_server(tiny_spec(mode="async", rounds=2), "cpu")
    srv.runtime_config = RuntimeConfig(mode="async", client_exec="batched")
    assert srv.run(srv.model.init(0, "cpu")).rounds == 2
    assert "using the sequential client loop" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# vectorized == standalone, inside the port
# ---------------------------------------------------------------------------

PARITY_CASES = {
    "fedavg": [tiny_spec(seed=s) for s in range(4)],
    "fedadam": [tiny_spec(seed=s, aggregator="fedadam") for s in range(4)],
    "mixed_aggregators_fixed_tuner": [
        tiny_spec(seed=0), tiny_spec(seed=1, aggregator="fednova"),
        tiny_spec(seed=0, tuner="fixed", preference=(0.25,) * 4)],
    "mixed_int8_lanes": [
        tiny_spec(seed=0), tiny_spec(seed=0, compression="int8"),
        tiny_spec(seed=1, aggregator="fednova", compression="int8"),
        tiny_spec(seed=1, mode="async"),
        tiny_spec(seed=1, mode="async", compression="int8")],
    "async": [tiny_spec(seed=s, mode="async", het=h)
              for s, h in ((0, "homogeneous"), (1, "stragglers"),
                           (2, "stragglers"))],
    "buffered": [tiny_spec(seed=s, mode="buffered", rounds=2)
                 for s in range(3)],
    "fedprox": [tiny_spec(seed=s, aggregator="fedprox", prox_mu=0.01)
                for s in range(2)],
    "failures_and_churn": [
        tiny_spec(seed=0, het="stragglers", failure_rate=0.3),
        tiny_spec(seed=1, mode="async", het="stragglers",
                  failure_rate=0.3, rounds=4),
        tiny_spec(seed=2, mode="buffered", het="mild", failure_rate=0.2,
                  churn="2:0.3", rounds=2)],
}


@pytest.mark.parametrize("case", sorted(PARITY_CASES))
def test_vectorized_matches_standalone_runs(case):
    specs = PARITY_CASES[case]
    base = [run_trial(s, device="cpu") for s in specs]
    vec = run_vectorized(specs, device="cpu")
    for s, b, v in zip(specs, base, vec):
        assert v.spec == s
        assert v.engine.startswith("vectorized")
        assert v.local_steps > 0
        assert_trial_parity(b, v)
    if case == "async":
        assert all(b.staleness_log and b.dispatch_log for b in base)


def test_fused_reduce_is_one_call_per_round_with_int8_lanes(monkeypatch):
    """Every FedAvg trial's aggregation is ONE ``fed_reduce`` call per
    round: T = pow2 of the trials, M = pow2 of their rows, compressed
    lanes' round trip in the same call."""
    calls = []
    real = t_runner.kernel_ops.fed_reduce

    def spy(w, rows, seg, t, base=None, **kw):
        calls.append((t, tuple(rows.shape), kw.get("quant_ref") is not None,
                      float(w[seg == 0].sum())))
        return real(w, rows, seg, t, base, **kw)
    monkeypatch.setattr(t_runner.kernel_ops, "fed_reduce", spy)
    specs = [tiny_spec(seed=s, compression="int8" if s % 2 else None,
                       rounds=2) for s in range(3)]
    res = run_vectorized(specs, device="cpu")
    assert len(calls) == 2 == res[0].rounds
    for t, (m, n), quant, _ in calls:
        assert t == 4 and quant and n == 38_464 and m & (m - 1) == 0


# ---------------------------------------------------------------------------
# the port against the JAX package
# ---------------------------------------------------------------------------

def test_vectorized_sweep_matches_the_reference():
    specs = [tiny_spec(seed=0), tiny_spec(seed=1, aggregator="fedadam"),
             tiny_spec(seed=2, compression="int8"),
             tiny_spec(seed=3, mode="async")]
    want = j_run_vectorized([JTrialSpec(**s.to_dict()) for s in specs])
    got = run_vectorized(specs, device="cpu", init_params=_reference_init)
    for s, w, g in zip(specs, want, got):
        assert g.spec.key() == w.spec.key()
        assert (g.history_m, g.history_e) == (w.history_m, w.history_e)
        assert (g.final_m, g.final_e) == (w.final_m, w.final_e)
        assert g.cost == w.cost
        assert g.dispatch_log == w.dispatch_log
        assert g.staleness_log == w.staleness_log
        np.testing.assert_allclose(g.history_acc, w.history_acc, atol=0.01)
        if s.aggregator == "fedadam":
            continue
        ref = j_build_server(JTrialSpec(**s.to_dict())).run(
            jax.tree.map(jnp.asarray, _reference_init(s)))
        atol = 2e-3 if s.compression else 1e-5
        for a, b in zip(leaves(g.params), jax.tree.leaves(ref.params)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=atol)


# ---------------------------------------------------------------------------
# store, CLI, and what is not ported
# ---------------------------------------------------------------------------

def test_sweep_cli_resumes_and_tabulates_on_cpu(tmp_path, capsys):
    out = str(tmp_path / "s.jsonl")
    first = t_sweep.main(["--preset", "smoke", "--device", "cpu",
                          "--limit", "8", "--out", out])
    assert len(first) == 8
    assert all(r.params is not None and r.engine == "vectorized/batched"
               for r in first)
    capsys.readouterr()
    t_sweep.main(["--preset", "smoke", "--device", "cpu", "--table",
                  "--out", out])
    text = capsys.readouterr().out
    assert "resume: skipping 8 completed, 16 pending" in text
    assert "FedTune overhead reduction vs FixedTuner" in text
    assert "| (1,0,0,0) |" in text


def test_store_written_by_the_reference_resumes_in_the_port(tmp_path,
                                                             capsys):
    out = str(tmp_path / "s.jsonl")
    first = j_smoke_grid().expand()[:1]
    j_run_sweep(first, store=JResultStore(out))
    ran = t_sweep.main(["--preset", "smoke", "--device", "cpu",
                        "--limit", "1", "--out", out])
    assert "resume: skipping 1 completed, 23 pending" in \
        capsys.readouterr().out
    assert ran[0].spec.key() != first[0].key()
    assert ran[0].spec.key() == t_sweep.smoke_grid().expand()[1].key()


def test_unported_paths_raise(tmp_path, monkeypatch, capsys):
    """The sharded pack in one process (no process group): it prints the
    reference's fallback and gives the batched pack's records, through
    ``run_vectorized``, ``run_sweep`` and the CLI."""
    out = str(tmp_path / "s.jsonl")
    batched = run_vectorized([tiny_spec()], pack="batched", device="cpu")

    def cli(pack):
        return t_sweep.main(["--pack", pack, "--device", "cpu", "--rounds",
                             "1", "--tuners", "fedtune", "--no-resume",
                             "--out", out])

    cli_batched = cli("batched")
    capsys.readouterr()
    for call, want in ((lambda: run_vectorized([tiny_spec()], pack="sharded",
                                               device="cpu"), batched),
                       (lambda: run_sweep([tiny_spec()], pack="sharded",
                                          device="cpu"), batched),
                       (lambda: cli("sharded"), cli_batched)):
        got = call()
        assert "falling back to batched packing" in capsys.readouterr().out
        assert [r.engine for r in got] == ["vectorized/batched"]
        assert_trial_parity(want[0], got[0])
    # --trace (with --trace-jax's NVTX ranges, absent from a CPU build)
    # writes a schema-valid trace and a metrics JSONL beside the store
    from repro_torch.obs.export import validate_chrome_trace
    for flags, base in ((["--trace"], "s"),
                        (["--trace", str(tmp_path / "t.trace.json"),
                          "--trace-jax"], "t")):
        t_sweep.main(flags + ["--device", "cpu", "--rounds", "1",
                              "--no-resume", "--out", out])
        trace = json.loads((tmp_path / f"{base}.trace.json").read_text())
        assert validate_chrome_trace(trace) == []
        assert any(ev["name"] == "TRAIN" for ev in trace["traceEvents"])
        assert (tmp_path / f"{base}.metrics.jsonl").exists()
    with pytest.raises(ValueError, match="batched"):
        run_vectorized([tiny_spec()], pack="origami", device="cpu")
    alone = run_trial(tiny_spec(client_exec="sharded"), device="cpu")
    assert "sharded execution needs a process group" in \
        capsys.readouterr().out
    assert_trial_parity(run_trial(tiny_spec(client_exec="batched"),
                                  device="cpu"), alone)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_sweep([tiny_spec()])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_sweep.main(["--preset", "smoke"])


def test_fedavg_from_rows_equals_its_lane_of_the_fused_reduce():
    """``_fedavg_from_rows`` (one trial, T=1) gives the bits of that
    trial's lane of ``_fused_sync_reduce`` (T = pow2 of the trials, rows
    padded with zero weights), int8 lanes and a zero-step client
    included: the reduce's packing invariance, through the runner."""
    from repro_torch.federated.aggregation import _flatten
    rng = np.random.default_rng(11)
    live = []
    for s in range(3):
        tr = t_runner._make_live(tiny_spec(
            seed=s, compression="int8" if s != 1 else None), "cpu", None)
        m = 3 + s
        gflat = _flatten(tr.params)[0]
        rows = [gflat + torch.from_numpy(rng.standard_normal(
            gflat.shape[0]).astype(np.float32) * 0.01) for _ in range(m)]
        rows[m - 1] = None if s == 2 else rows[m - 1]   # a zero-step client
        tr.cohort = t_runner._Cohort(
            cids=list(range(m)), streams=[], n_steps=[1] * m,
            sizes=[int(v) for v in rng.integers(1, 300, m)],
            flat_rows=rows)
        live.append(tr)
    t_runner._fused_sync_reduce(live)
    for tr in live:
        fused = _flatten(tr.cohort.agg_params)[0]
        tr.cohort.agg_params = None
        alone = _flatten(t_runner._fedavg_from_rows(tr))[0]
        assert torch.equal(fused, alone)
