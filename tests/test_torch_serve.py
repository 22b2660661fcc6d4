"""The port's trial serving: the continuous-batching scheduler
(``repro_torch.experiments.scheduler``), crash-safe snapshots
(``experiments.snapshot``), the checkpointer (``repro_torch.checkpoint``)
and the ``serve_trials`` CLI, at a tiny size on the CPU.

Inside the port, mirroring tests/test_scheduler.py and tests/test_chaos.py:
``LanePool`` hands out the lowest free lane and never double-assigns;
``TrialQueue`` dedups, skips completed keys and leaves a torn tail of its
watched file for the next poll; every trial served through ``serve`` (sync,
async, buffered and mixed, with lanes retiring and refilling mid-flight)
gives its standalone ``run_trial``'s records under ``assert_trial_parity``;
a drain killed after any macro-step and restored from its snapshot ends
with the uninterrupted drain's store, row for row (``wall`` aside).

Against the JAX package: the port's ``serve`` and the reference's, from the
reference's initial params, give the same store rows with ``wall`` aside,
in the same order (records only: params are not in a row, so FedAdam's
drift in params, tests/test_torch_sweep.py, does not enter); checkpoints and
snapshots written by ``repro.checkpoint`` (a bf16 leaf included) load in
the port with the same bits, and the port's files load in the reference.
"""

import json
from collections import deque

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import checkpoint as jck  # noqa: E402
from repro.experiments import ResultStore as JResultStore  # noqa: E402
from repro.experiments import TrialSpec as JTrialSpec  # noqa: E402
from repro.experiments import serve as j_serve  # noqa: E402
from repro.experiments.runner import build_server as j_build_server  # noqa: E402
from repro_torch import checkpoint as tck  # noqa: E402
from repro_torch.experiments import (LanePool, ResultStore,  # noqa: E402
                                     TrialQueue, TrialScheduler, TrialSpec,
                                     run_trial, serve)
from repro_torch.launch import serve_trials as t_serve_cli  # noqa: E402
from repro_torch.launch import train as t_train  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402


def tiny_spec(**kw):
    base = dict(dataset="emnist", aggregator="fedavg", seed=0,
                tuner="fedtune", m0=3, e0=1.0, rounds=3,
                target_accuracy=0.99, batch_size=5, eval_points=128)
    base.update(kw)
    return TrialSpec(**base)


def assert_trial_parity(base, vec):
    """tests/test_scheduler.py's contract: every round record equal."""
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


def standalone(specs):
    return {s.key(): run_trial(s, device="cpu") for s in specs}


def mixed_specs(n=4):
    """Staggered budgets over sync/async/buffered (tests/test_chaos.py)."""
    return [tiny_spec(seed=s, rounds=1 + s % 2,
                      mode=("sync", "async", "buffered", "sync",
                            "async")[s % 5])
            for s in range(n)]


def rows_sans_wall(store):
    out = []
    for r in store.load():
        r = dict(r)
        r.pop("wall", None)
        out.append(r)
    return out


# ---------------------------------------------------------------------------
# LanePool and TrialQueue
# ---------------------------------------------------------------------------

def test_lane_pool_alloc_release_reuse():
    pool = LanePool(3)
    assert [pool.alloc(k) for k in "abc"] == [0, 1, 2]
    assert (pool.n_live, pool.n_free) == (3, 0)
    assert pool.occupancy() == 1.0
    assert pool.live_mask() == [True, True, True]
    with pytest.raises(ValueError):
        pool.alloc("d")                      # full
    with pytest.raises(ValueError):
        pool.alloc("a")                      # double admission
    assert pool.release("b") == 1
    assert pool.live_mask() == [True, False, True]
    assert pool.live_keys() == ["a", "c"]
    assert pool.alloc("d") == 1              # lowest free lane, reused
    assert pool.lane_of("d") == 1 and pool.key_of(1) == "d"
    with pytest.raises(KeyError):
        pool.release("b")                    # released twice
    with pytest.raises(ValueError):
        LanePool(0)


@pytest.mark.parametrize("seed", range(6))
def test_lane_pool_invariants_under_interleaving(seed):
    """No double assignment, ``alloc`` hands out the LOWEST free lane, and
    the admission sequence is the queue order whichever live trial
    retires when (tests/test_scheduler.py's property, over seeded
    draws)."""
    rng = np.random.default_rng(seed)
    cap, n_trials = int(rng.integers(1, 7)), int(rng.integers(1, 21))
    pending = deque(f"k{i}" for i in range(n_trials))
    pool = LanePool(cap)
    admitted = []
    while pending or pool.n_live:
        while pending and pool.n_free:
            key = pending.popleft()
            free_before = [lane for lane in range(cap)
                           if pool.key_of(lane) is None]
            assert pool.alloc(key) == min(free_before)
            admitted.append(key)
        live = pool.live_keys()
        assert len(live) == len(set(live)) == pool.n_live
        for key in live:
            assert pool.key_of(pool.lane_of(key)) == key
        assert pool.n_live + pool.n_free == cap
        victim = live[int(rng.integers(len(live)))]
        assert pool.key_of(pool.release(victim)) is None
    assert admitted == [f"k{i}" for i in range(n_trials)]


def test_trial_queue_dedup_and_completed():
    done_key = tiny_spec(seed=2).key()
    q = TrialQueue(specs=[tiny_spec(seed=0), tiny_spec(seed=1),
                          tiny_spec(seed=0)], completed=[done_key])
    assert (q.n_submitted, q.n_skipped) == (2, 1)
    assert not q.submit(tiny_spec(seed=2))             # already completed
    assert q.n_skipped == 2 and len(q) == 2
    first = q.pop()
    assert first.key() == tiny_spec(seed=0).key()      # FIFO
    q.mark_done(first.key())
    assert not q.submit(tiny_spec(seed=0))             # done after the fact


def test_trial_queue_watch_file(tmp_path):
    path = tmp_path / "subs.jsonl"
    q = TrialQueue(watch_path=str(path))
    assert q.poll() == 0                               # absent file: no-op
    with open(path, "w") as f:
        f.write(json.dumps({"spec": tiny_spec(seed=0).to_dict()}) + "\n")
        f.write("{not json\n")                          # malformed: skipped
        f.write(json.dumps(tiny_spec(seed=1).to_dict()))  # torn tail
    assert q.poll() == 1 and len(q) == 1
    assert q.poll() == 0                # tail still incomplete
    with open(path, "a") as f:
        f.write("\n")
        f.write(json.dumps({"spec": tiny_spec(seed=0).to_dict()}) + "\n")
    assert q.poll() == 1                # tail retried; duplicate skipped
    assert [q.pop().key() for _ in range(2)] == [tiny_spec(seed=0).key(),
                                                 tiny_spec(seed=1).key()]


# ---------------------------------------------------------------------------
# served == standalone, with mid-flight admission and retirement
# ---------------------------------------------------------------------------

SERVE_CASES = {
    "sync": ([tiny_spec(seed=s, rounds=1 + s % 3,
                        compression="int8" if s == 4 else None)
              for s in range(6)], 2),
    "events": ([tiny_spec(seed=s, rounds=1 + s % 3,
                          mode="async" if s % 2 == 0 else "buffered")
                for s in range(6)], 2),
    "mixed": ([tiny_spec(seed=s, rounds=1 + s) for s in range(3)]
              + [tiny_spec(seed=3, rounds=2, mode="async"),
                 tiny_spec(seed=4, rounds=1, mode="buffered"),
                 tiny_spec(seed=5, rounds=2, aggregator="fedadam")], 3),
}


@pytest.mark.parametrize("case", sorted(SERVE_CASES))
def test_serve_matches_standalone_runs_midflight(case):
    specs, lanes = SERVE_CASES[case]
    base = standalone(specs)
    got = serve(specs, max_lanes=lanes, device="cpu")
    assert len(got) == len(specs)
    for r in got:
        assert_trial_parity(base[r.spec.key()], r)
        assert r.local_steps > 0
        assert all(t.device.type == "cpu" for t in leaves(r.params))
        assert r.engine in ("serve-sync/batched", "serve-events/batched")


def test_scheduler_admission_order_and_stats():
    specs = [tiny_spec(seed=s, rounds=1 + s % 2) for s in range(5)]
    q = TrialQueue(specs=specs)
    sched = TrialScheduler(q, max_lanes=2, device="cpu")
    sched.drain()
    st_ = sched.stats
    assert (st_.admitted, st_.retired) == (5, 5)
    assert [k for k, _ in st_.admission_log] == [s.key() for s in specs]
    assert st_.steps > 0 and 0.0 < st_.mean_occupancy <= 1.0
    assert sched.pool.n_live == 0 and not q


def test_serve_kill_and_resume(tmp_path):
    store = ResultStore(str(tmp_path / "serve.jsonl"))
    specs = [tiny_spec(seed=s, rounds=1 + s % 2) for s in range(5)]
    first = serve(specs, max_lanes=2, store=store, max_results=2,
                  device="cpu")
    assert 2 <= len(first) < 5
    done = {r.spec.key() for r in first}
    second = serve(specs, max_lanes=2, store=store, device="cpu")
    assert {r.spec.key() for r in second} == {s.key() for s in specs} - done
    keys = [r["key"] for r in store.load()]
    assert len(keys) == 5 and len(set(keys)) == 5
    assert serve(specs, max_lanes=2, store=store, device="cpu") == []


# ---------------------------------------------------------------------------
# kill and restore (tests/test_chaos.py's matrix, with the port's helpers)
# ---------------------------------------------------------------------------

def drain_uninterrupted(specs, path, max_lanes=2):
    store = ResultStore(str(path))
    sched = TrialScheduler(TrialQueue(specs=list(specs)), max_lanes=max_lanes,
                           store=store, device="cpu")
    sched.drain()
    return store, sched


def drain_with_kill(specs, tmp_path, tag, kill_after, snapshot_every=1,
                    max_lanes=2):
    """One coordinator killed after ``kill_after`` macro-steps (no final
    snapshot), its successor restored from the two-slot snapshot and
    drained to the end.  Returns (store, final scheduler, steps executed
    per incarnation, duplicates suppressed)."""
    store = ResultStore(str(tmp_path / f"{tag}.jsonl"))
    snap = str(tmp_path / f"{tag}.snap")
    sched = TrialScheduler(TrialQueue(specs=list(specs)), max_lanes=max_lanes,
                           store=store, snapshot_path=snap,
                           snapshot_every=snapshot_every, device="cpu")
    sched.drain(max_steps=kill_after)
    executed = [sched.stats.steps]
    if not sched.pool.n_live and not sched.queue:
        return store, sched, executed, 0
    dead = sched
    sched = TrialScheduler.restore(snap, store=store, device="cpu",
                                   snapshot_every=snapshot_every)
    for key in store.completed_keys():
        sched.queue.mark_done(key)
    before = sched.stats.steps
    sched.drain()
    executed.append(sched.stats.steps - before)
    return (store, sched, executed,
            dead.duplicates_suppressed + sched.duplicates_suppressed)


def assert_pool_drained(sched):
    pool = sched.pool
    assert pool.n_live == 0 and pool.n_free == pool.capacity
    assert sorted(pool._free) == list(range(pool.capacity))
    assert pool._page == {} and pool._lane == {}


def test_kill_at_every_macro_step_resumes_identically(tmp_path):
    specs = mixed_specs(n=4)
    ref, ref_sched = drain_uninterrupted(specs, tmp_path / "ref.jsonl")
    total = ref_sched.stats.steps
    assert total >= 3
    want = rows_sans_wall(ref)
    assert sorted(r["key"] for r in want) == sorted(s.key() for s in specs)
    for k in range(1, total + 1):
        store, sched, executed, dupes = drain_with_kill(specs, tmp_path,
                                                        f"k{k}", k)
        assert rows_sans_wall(store) == want, f"kill at step {k}"
        assert_pool_drained(sched)
        assert sum(executed) <= total + 1      # at most one step replayed
        assert sched.stats.steps == total
        assert dupes <= sched.pool.capacity


def test_kill_with_sparse_snapshots_replays_at_most_every(tmp_path):
    specs = mixed_specs(n=4)
    ref, ref_sched = drain_uninterrupted(specs, tmp_path / "ref3.jsonl")
    total = ref_sched.stats.steps
    want = rows_sans_wall(ref)
    for k in (2, total // 2 + 1, total):
        store, _sched, executed, _ = drain_with_kill(
            specs, tmp_path, f"s{k}", k, snapshot_every=3)
        assert rows_sans_wall(store) == want, f"kill at step {k}"
        assert sum(executed) <= total + 3


def test_restore_keeps_local_steps_and_device(tmp_path):
    """A restored drain's results carry the uninterrupted drain's
    ``local_steps`` (a port field the snapshot must keep) and params on
    the scheduler's device."""
    specs = mixed_specs(n=3)
    plain = {r.spec.key(): r for r in serve(specs, max_lanes=3,
                                            device="cpu")}
    snap = str(tmp_path / "ls.snap")
    sched = TrialScheduler(TrialQueue(specs=specs), max_lanes=3,
                           snapshot_path=snap, device="cpu")
    sched.drain(max_steps=1)
    resumed = TrialScheduler.restore(snap, device="cpu")
    assert resumed.device.type == "cpu" and resumed.pool.n_live == 3
    got = resumed.drain()
    assert {r.spec.key() for r in got} == set(plain)
    for r in got:
        assert r.local_steps == plain[r.spec.key()].local_steps > 0
        assert_trial_parity(plain[r.spec.key()], r)
        for a, b in zip(leaves(r.params), leaves(plain[r.spec.key()].params)):
            assert a.device.type == "cpu" and torch.equal(a, b)


def test_sharded_pack_raises(tmp_path, capsys):
    """The sharded pack in one process (no process group): ``serve``,
    ``TrialScheduler`` and the CLI print the reference's fallback and
    serve with the batched pack, giving the batched drain's records."""
    fallback = "falling back to batched packing"
    want = serve([tiny_spec()], pack="batched", device="cpu")
    capsys.readouterr()
    got = serve([tiny_spec()], pack="sharded", device="cpu")
    assert fallback in capsys.readouterr().out
    assert [r.engine for r in got] == ["serve-sync/batched"]
    assert_trial_parity(want[0], got[0])
    sched = TrialScheduler(TrialQueue(), pack="sharded", device="cpu")
    assert fallback in capsys.readouterr().out
    assert sched._pack == "batched" and sched._mesh is None

    def cli(pack):
        out = str(tmp_path / f"{pack}.jsonl")
        t_serve_cli.main(["--preset", "serve-smoke", "--pack", pack,
                          "--device", "cpu", "--out", out])
        return {r["key"]: r for r in ResultStore(out).load()}

    rows, rows_sharded = cli("batched"), cli("sharded")
    assert fallback in capsys.readouterr().out
    assert rows.keys() == rows_sharded.keys() and len(rows) == 12
    for key, r in rows.items():
        for field in ("history_m", "history_e", "history_acc", "cost",
                      "rounds", "engine"):
            assert rows_sharded[key][field] == r[field], (key, field)


# ---------------------------------------------------------------------------
# the port against the JAX package
# ---------------------------------------------------------------------------

def _reference_init(spec):
    srv = j_build_server(JTrialSpec(**spec.to_dict()))
    return jax.tree.map(np.asarray,
                        srv.model.init(jax.random.PRNGKey(spec.seed)))


def test_serve_matches_the_reference_serve(tmp_path):
    specs = ([tiny_spec(seed=s, rounds=1 + s % 2,
                        compression="int8" if s == 1 else None)
              for s in range(3)]
             + [tiny_spec(seed=3, rounds=2, mode="async"),
                tiny_spec(seed=4, rounds=2, mode="buffered"),
                tiny_spec(seed=5, rounds=2, aggregator="fedadam")])
    got_store = ResultStore(str(tmp_path / "port.jsonl"))
    serve(specs, max_lanes=3, store=got_store, device="cpu",
          init_params=_reference_init)
    want_store = JResultStore(str(tmp_path / "ref.jsonl"))
    j_serve([JTrialSpec(**s.to_dict()) for s in specs], max_lanes=3,
            store=want_store)
    got, want = rows_sans_wall(got_store), rows_sans_wall(want_store)
    assert len(got) == len(specs)
    assert got == want


def _bf16_tree():
    rng = np.random.default_rng(3)
    return {"layers": [{"b": rng.standard_normal(5).astype(np.float32),
                        "w": rng.standard_normal((4, 5)).astype(np.float32)}],
            "h": rng.standard_normal((3, 7)).astype(np.float32)}


def _template(device="cpu"):
    return {"layers": [{"b": torch.zeros(5, device=device),
                        "w": torch.zeros((4, 5), device=device)}],
            "h": torch.zeros((3, 7), dtype=torch.bfloat16, device=device)}


def _bits(t):
    if isinstance(t, torch.Tensor):
        t = t.cpu()
        return (t.view(torch.int16) if t.dtype == torch.bfloat16
                else t).numpy().tobytes()
    a = np.asarray(t)
    return (a.view(np.int16) if a.dtype.itemsize == 2 else a).tobytes()


def test_reference_checkpoint_and_snapshot_load_with_the_same_bits(tmp_path):
    tree = _bf16_tree()
    jtree = {"layers": [{k: jnp.asarray(v) for k, v in tree["layers"][0]
                         .items()}], "h": jnp.asarray(tree["h"],
                                                      jnp.bfloat16)}
    jck.save_checkpoint(str(tmp_path / "ck"), jtree, step=4,
                        metadata={"x": 1})
    got, meta = tck.load_checkpoint(str(tmp_path / "ck"), _template())
    assert meta == {"step": 4, "x": 1}
    jck.save_snapshot(str(tmp_path / "snap"), jtree, step=2)
    arrays, smeta = tck.load_snapshot(str(tmp_path / "snap"))
    assert smeta["step"] == 2 and smeta["dtypes"]["h"] == "bfloat16"
    snap = tck.restore_tree(arrays, _template())
    for out in (got, snap):
        assert out["h"].dtype == torch.bfloat16
        for a, b in zip(leaves(out), jax.tree.leaves(jtree)):
            assert _bits(a) == _bits(b)


def test_port_snapshot_loads_in_the_reference(tmp_path):
    t = tck.restore_tree({k: v for k, v in tck.checkpointer
                          .flatten_to_numpy(_bf16_tree())[0].items()},
                         {"layers": [{"b": torch.zeros(5),
                                      "w": torch.zeros((4, 5))}],
                          "h": torch.zeros((3, 7))})
    t["h"] = t["h"].to(torch.bfloat16)
    tck.save_snapshot(str(tmp_path / "snap"), t, step=1)
    arrays, meta = jck.load_snapshot(str(tmp_path / "snap"))
    assert str(arrays["h"].dtype) == "bfloat16"
    for k, leaf in tck.checkpointer.keyed_leaves(t):
        assert _bits(leaf) == _bits(arrays[k])


def test_snapshot_two_slot_fallback_after_a_torn_slot(tmp_path):
    base = str(tmp_path / "s.snap")
    t1 = {"a": torch.arange(6, dtype=torch.float32),
          "h": torch.ones(3, dtype=torch.bfloat16)}
    t2 = {"a": torch.arange(6, dtype=torch.float32) * 2,
          "h": torch.full((3,), 3.0, dtype=torch.bfloat16)}
    p1 = tck.save_snapshot(base, t1, step=1)
    p2 = tck.save_snapshot(base, t2, step=2)
    assert p1 != p2                                  # two slots in turn
    arrays, meta = tck.load_snapshot(base)
    assert meta["step"] == 2
    # tear the newer slot's npz: the loader falls back a generation
    with open(p2, "r+b") as f:
        f.truncate(40)
    arrays, meta = tck.load_snapshot(base)
    assert meta["step"] == 1
    got = tck.restore_tree(arrays, {"a": torch.zeros(6),
                                    "h": torch.zeros(3, dtype=torch.bfloat16)})
    assert torch.equal(got["a"], t1["a"]) and torch.equal(got["h"], t1["h"])
    # the next save overwrites the torn slot, not the valid one
    assert tck.save_snapshot(base, t2, step=3) == p2
    assert tck.load_snapshot(base)[1]["step"] == 3
    with open(p2, "wb"):
        pass
    with open(p1, "wb"):
        pass
    with pytest.raises(FileNotFoundError):
        tck.load_snapshot(base)


def test_params_from_numpy_carries_bf16_leaves(tmp_path):
    """A bf16 leaf crosses as its 2-byte pattern: the ``|V2`` array numpy
    reads back for the reference's bfloat16, or a ``uint16`` array named
    ``"bfloat16"`` (or with a bf16 template leaf)."""
    from repro_torch.weights import params_from_numpy, params_to_numpy
    ref = np.asarray(jnp.linspace(-3, 3, 12, dtype=jnp.bfloat16))
    np.savez(tmp_path / "h.npz", h=ref)
    void = np.load(tmp_path / "h.npz")["h"]
    assert void.dtype.kind == "V"
    raw = ref.view(np.uint16)
    for tree, kw in (({"h": void}, {}),
                     ({"h": raw}, {"dtype_names": ["bfloat16"]}),
                     ({"h": raw}, {"template": {"h": torch.zeros(
                         12, dtype=torch.bfloat16)}})):
        got = params_from_numpy(tree, "cpu", **kw)["h"]
        assert got.dtype == torch.bfloat16
        assert _bits(got) == _bits(ref)
        assert np.array_equal(params_to_numpy({"h": got})["h"], raw)
    with pytest.raises(TypeError, match="uint16"):     # bits with no name
        params_from_numpy({"h": raw}, "cpu",
                          template={"h": torch.zeros(12)})
    with pytest.raises(ValueError, match="template wants"):
        params_from_numpy({"h": void}, "cpu",
                          template={"h": torch.zeros(12)})


def test_bf16_checkpoint_round_trip_and_dtype_checks(tmp_path):
    t = _template()
    t["h"] = torch.randn((3, 7)).to(torch.bfloat16)
    t["layers"][0]["w"] = torch.randn((4, 5))
    tck.save_checkpoint(str(tmp_path / "rt"), t)
    got, _ = tck.load_checkpoint(str(tmp_path / "rt"), _template())
    for a, b in zip(leaves(got), leaves(t)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    wrong = _template()
    wrong["layers"][0]["w"] = torch.zeros((4, 5), dtype=torch.float64)
    with pytest.raises(ValueError, match="layers/0/w"):
        tck.load_checkpoint(str(tmp_path / "rt"), wrong)


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

def test_serve_trials_cli_resumes_after_limit(tmp_path, capsys):
    out = str(tmp_path / "serve.jsonl")
    first = t_serve_cli.main(["--preset", "serve-smoke", "--device", "cpu",
                              "--limit", "6", "--out", out])
    n_first = first.stats.retired
    assert 6 <= n_first < 12
    capsys.readouterr()
    second = t_serve_cli.main(["--preset", "serve-smoke", "--device", "cpu",
                               "--out", out, "--trace"])
    text = capsys.readouterr().out
    assert f"skipping {n_first} completed/duplicate" in text
    assert second.stats.retired == 12 - n_first
    keys = [r["key"] for r in ResultStore(out).load()]
    assert len(keys) == len(set(keys)) == 12
    trace = json.loads((tmp_path / "serve.trace.json").read_text())
    from repro_torch.obs.export import validate_chrome_trace
    assert validate_chrome_trace(trace) == []
    assert (tmp_path / "serve.metrics.jsonl").exists()


def test_serve_trials_cli_kill_after_steps_and_snapshot_resume(tmp_path,
                                                               capsys):
    out = str(tmp_path / "chaos.jsonl")
    common = ["--preset", "serve-smoke", "--device", "cpu", "--out", out,
              "--snapshot", "--max-lanes", "3"]
    with pytest.raises(SystemExit) as e:
        t_serve_cli.main(common + ["--kill-after-steps", "2"])
    assert e.value.code == 3
    assert "simulated crash after 2" in capsys.readouterr().out
    resumed = t_serve_cli.main(common)
    assert "resumed from" in capsys.readouterr().out
    ref_out = str(tmp_path / "ref.jsonl")
    t_serve_cli.main(["--preset", "serve-smoke", "--device", "cpu",
                      "--out", ref_out, "--max-lanes", "3"])
    assert rows_sans_wall(ResultStore(out)) == \
        rows_sans_wall(ResultStore(ref_out))
    assert resumed.pool.n_live == 0


def test_train_checkpoint_reads_in_the_reference(tmp_path):
    from repro.configs.paper_models import MLPConfig as JMLPConfig
    from repro.models import build_model as j_build_model
    ck = str(tmp_path / "ck" / "final")
    res = t_train.main(["--device", "cpu", "--rounds", "1", "--m", "2",
                        "--e", "1", "--checkpoint", ck])
    m = j_build_model(JMLPConfig(name="mlp", in_dim=784, hidden=(48,),
                                 n_classes=16))
    got, meta = jck.load_checkpoint(ck, m.init(jax.random.PRNGKey(0)))
    assert meta["step"] == res.rounds == 1
    assert meta["final_accuracy"] == res.final_accuracy
    for a, b in zip(jax.tree.leaves(got), leaves(res.params)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
