"""The port's multi-GPU FedTune path on the CPU: the cohort sharded over
``torch.distributed`` gloo ranks that ``launch.mesh.run_ranks`` spawns.

Against the JAX package, on the same numpy data and JAX's ``model.init``
params (carried across by ``repro_torch.weights``), at the reference
test's sizes (tests/test_sharded.py: 24 clients, a 12-16-4 MLP):
  * ``sharded_fedavg_train`` at D=2 and D=4, with and without int8, is
    within 1e-5 of JAX's ``batched_local_train`` + FedAvg, its last losses
    at rtol 1e-4 (the reference's own pins); every rank returns bitwise
    the same aggregate, and a second run bitwise the first;
  * at D=4 it is within 1e-5 of the reference's own sharded path, run in
    a subprocess on 4 XLA CPU devices;
  * a 4-round sharded ``FLServer`` trial at D=2, FedTune on, keeps JAX's
    batched trial's (M, E) and costs exactly, accuracies within 1e-5 and
    params within 1e-4 (tests/test_sharded.py:137-142).
Inside the port: the sharded aggregate is within 1e-5 of the port's
batched path, with zero-step clients and with a cohort smaller than D
(every slot of some rank's block is padding); ``run_sweep(pack=
"sharded")`` at D=2 gives the batched pack's store rows ((M, E) and costs
equal, accuracy within 1e-5), written once, by rank 0; and
``StackedEvaluator.evaluate(mesh=)`` at D=2 over an odd lane count equals
the unsharded call exactly.

A spawn costs seconds, so one D=2 and one D=4 spawn serve every case
(module fixtures).  The ranks import this file but no JAX: the JAX
package is imported inside the tests only.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

from repro_torch.configs.paper_models import MLPConfig  # noqa: E402
from repro_torch.core import CostModel, FedTune, FedTuneConfig, Preference  # noqa: E402
from repro_torch.core.tuner import HyperParams  # noqa: E402
from repro_torch.data.synthetic import DataSpec, make_dataset  # noqa: E402
from repro_torch.experiments import ResultStore, TrialSpec, run_sweep  # noqa: E402
from repro_torch.experiments.runner import build_server  # noqa: E402
from repro_torch.federated import FLConfig, FLServer, get_aggregator  # noqa: E402
from repro_torch.federated.evaluation import StackedEvaluator  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim.optimizers import get_optimizer  # noqa: E402
from repro_torch.runtime import (RuntimeConfig, batched_local_train,  # noqa: E402
                                 sharded_fedavg_train)
from repro_torch.runtime import sharded as sharded_mod  # noqa: E402
from repro_torch.runtime.engine import EventDrivenRuntime  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402
from repro_torch.weights import params_from_numpy  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
SPEC = dict(name="shard_test", n_classes=4, shape=(12,), n_train_clients=24,
            n_test_clients=8, size_log_mean=2.5, size_log_std=0.5, seed=1)
N_PARAMS = 12 * 16 + 16 + 16 * 4 + 4
CIDS = [0, 3, 7, 11, 15, 16, 20]      # 7 clients: not a multiple of D
COMPS = (None, "int8")
PREF = (0.25, 0.25, 0.25, 0.25)


# ---------------------------------------------------------------------------
# the port's side: what every rank runs (no JAX here)
# ---------------------------------------------------------------------------

def _model():
    return build_model(MLPConfig(name="mlp_shard", in_dim=12, hidden=(16,),
                                 n_classes=4))


def _optimizer():
    return get_optimizer("sgd", 0.05, momentum=0.9)


def _zero_step_data():
    rngd = np.random.default_rng(0)
    return [(rngd.normal(size=(12, 12)).astype(np.float32),
             rngd.integers(0, 4, 12).astype(np.int32)),
            (rngd.normal(size=(1, 12)).astype(np.float32),
             rngd.integers(0, 4, 1).astype(np.int32))]   # round(0.4*1) == 0


def _cohorts():
    """(name, data, passes, compression) of every sharded_fedavg_train
    case; ``small`` has fewer clients than ranks."""
    ds = make_dataset(DataSpec(**SPEC))
    cohort = [ds.client_data(c) for c in CIDS]
    out = [(f"cohort_{c}", cohort, 2.0, c) for c in COMPS]
    out.append(("small", [ds.client_data(c) for c in (2, 5, 9)][:1], 1.0,
                None))
    out.append(("small3", [ds.client_data(c) for c in (2, 5, 9)], 1.0,
                "int8"))
    out.append(("zero_step", _zero_step_data(), 0.4, None))
    return out


def _train(mesh, p0, data, passes, comp):
    res = sharded_fedavg_train(_model(), params_from_numpy(p0, "cpu"), data,
                               passes=passes, batch_size=4,
                               optimizer=_optimizer(),
                               rng=np.random.default_rng(42), mesh=mesh,
                               compression=comp)
    return dict(params=leaves(res.params), losses=res.last_losses,
                n_steps=res.n_steps, n_examples=res.n_examples)


def _server(client_exec, max_rounds=4, m=5, e=2.0, aggregator="fedavg",
            mode="sync"):
    return FLServer(
        _model(), make_dataset(DataSpec(**SPEC)), get_aggregator(aggregator),
        _optimizer(),
        CostModel(flops_per_example=2 * N_PARAMS, param_count=N_PARAMS),
        FLConfig(m=m, e=e, batch_size=4, target_accuracy=0.99,
                 max_rounds=max_rounds, eval_points=128),
        tuner=FedTune(FedTuneConfig(preference=Preference(*PREF)),
                      HyperParams(m, e)),
        runtime_config=RuntimeConfig(mode=mode, client_exec=client_exec),
        device="cpu")


def _sweep_specs():
    base = dict(dataset="emnist", aggregator="fedavg", tuner="fedtune",
                m0=3, e0=1.0, rounds=3, target_accuracy=0.99, batch_size=5,
                eval_points=128)
    return [TrialSpec(seed=s, **base) for s in (0, 1, 2)] + [
        TrialSpec(seed=0, compression="int8", **base)]


def _eval_lanes():
    srv = build_server(_sweep_specs()[0], "cpu")
    return srv, [srv.model.init(s, "cpu") for s in range(5)]


def _rank_cases(mesh, p0, store_path):
    """Every case one spawn serves: each sharded_fedavg_train cohort twice
    (the second run must repeat the first's bits); at D=2 also a sharded
    trial, a sharded sweep and the sharded stacked evaluation."""
    out = {"rank": mesh.rank, "size": mesh.size, "backend": mesh.backend,
           "device": str(mesh.device), "runs": {}}
    for name, data, passes, comp in _cohorts():
        out["runs"][name] = [_train(mesh, p0, data, passes, comp)
                             for _ in range(2)]
    if mesh.size != 2:
        return out
    sharded_mod.rounds = 0
    srv = _server("sharded")
    eng = EventDrivenRuntime(srv, config=srv.runtime_config)
    res = srv.run(params_from_numpy(p0, "cpu"))
    out["trial"] = dict(
        client_exec=eng.client_exec, sharded_rounds=sharded_mod.rounds,
        m_e=[(h.m, h.e) for h in res.history],
        acc=[h.accuracy for h in res.history],
        cost=list(res.total_cost.as_tuple()), params=leaves(res.params))
    sharded_mod.rounds = 0
    recs = run_sweep(_sweep_specs(), store=ResultStore(store_path),
                     pack="sharded", device="cpu")
    out["sweep"] = dict(records=[r.to_record() for r in recs],
                        sharded_rounds=sharded_mod.rounds)
    srv, lanes = _eval_lanes()
    ev = StackedEvaluator(srv.model, srv.dataset, 128, "cpu")
    out["eval"] = dict(mesh=ev.evaluate(lanes, mesh=mesh),
                       mesh_pad8=ev.evaluate(lanes, mesh=mesh, pad_to=8),
                       plain=ev.evaluate(lanes))
    return out


# ---------------------------------------------------------------------------
# fixtures: the JAX side and one spawn per world size
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def p0():
    import jax
    from repro.configs.paper_models import MLPConfig as JMLPConfig
    from repro.models import build_model as j_build_model
    model = j_build_model(JMLPConfig(name="mlp_shard", in_dim=12,
                                     hidden=(16,), n_classes=4))
    return jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def ranks(p0, tmp_path_factory):
    """world size -> (each rank's results, the D=2 sweep's store path)."""
    out = {}
    for d in (2, 4):
        tmp = tmp_path_factory.mktemp(f"ranks{d}")
        store = str(tmp / "sweep.jsonl")
        out[d] = (mesh_mod.run_ranks(_rank_cases, d, device="cpu",
                                     init_file=str(tmp / "rendezvous"),
                                     args=(p0, store)), store)
    return out


@pytest.fixture(scope="module")
def jax_fedavg(p0):
    """JAX's batched_local_train + FedAvg on every cohort, as numpy."""
    import jax
    import jax.numpy as jnp
    from repro.federated import get_aggregator as j_get_aggregator
    from repro.models import build_model as j_build_model
    from repro.configs.paper_models import MLPConfig as JMLPConfig
    from repro.optim.optimizers import get_optimizer as j_get_optimizer
    from repro.runtime import batched_local_train as j_batched
    model = j_build_model(JMLPConfig(name="mlp_shard", in_dim=12,
                                     hidden=(16,), n_classes=4))
    params = jax.tree.map(jnp.asarray, p0)
    out = {}
    for name, data, passes, comp in _cohorts():
        upd = j_batched(model, params, data, passes=passes, batch_size=4,
                        optimizer=j_get_optimizer("sgd", 0.05, momentum=0.9),
                        rng=np.random.default_rng(42), compression=comp)
        agg = j_get_aggregator("fedavg")(params, upd)
        out[name] = dict(params=[np.asarray(x) for x in jax.tree.leaves(agg)],
                         losses=np.array([u.last_loss for u in upd]),
                         n_steps=[u.n_steps for u in upd])
    return out


def _close(got, want, atol):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=atol,
                                   rtol=0)


def _bitwise(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# sharded_fedavg_train
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", (2, 4))
@pytest.mark.parametrize("comp", COMPS)
def test_sharded_fedavg_matches_jax_batched_fedavg(ranks, jax_fedavg,
                                                   world, comp):
    name = f"cohort_{comp}"
    got = ranks[world][0][0]["runs"][name][0]
    want = jax_fedavg[name]
    assert got["n_steps"] == want["n_steps"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4)
    _close(got["params"], want["params"], 1e-5)


@pytest.mark.parametrize("world", (2, 4))
def test_every_rank_and_every_run_gives_the_same_bits(ranks, world):
    results = ranks[world][0]
    assert [r["rank"] for r in results] == list(range(world))
    assert {(r["size"], r["backend"], r["device"]) for r in results} == {
        (world, "gloo", "cpu")}
    for name, runs in results[0]["runs"].items():
        first = runs[0]
        for r in results:
            for run in r["runs"][name]:
                assert _bitwise(run["params"], first["params"]), name
                np.testing.assert_array_equal(run["losses"], first["losses"])


def test_sharded_matches_the_ports_batched_path(ranks, p0):
    for name, data, passes, comp in _cohorts():
        params = params_from_numpy(p0, "cpu")
        upd = batched_local_train(_model(), params, data, passes=passes,
                                  batch_size=4, optimizer=_optimizer(),
                                  rng=np.random.default_rng(42),
                                  compression=comp)
        want = get_aggregator("fedavg")(params, upd)
        for world in (2, 4):
            got = ranks[world][0][0]["runs"][name][0]
            assert got["n_steps"] == [u.n_steps for u in upd]
            np.testing.assert_allclose(got["losses"],
                                       [u.last_loss for u in upd],
                                       rtol=1e-4)
            _close(got["params"], leaves(want), 1e-5)


def test_zero_step_client_enters_the_mean_at_global(ranks, jax_fedavg):
    for world in (2, 4):
        got = ranks[world][0][0]["runs"]["zero_step"][0]
        assert got["n_steps"][1] == 0
        _close(got["params"], jax_fedavg["zero_step"]["params"], 1e-5)


@pytest.mark.parametrize("name", ("small", "small3"))
def test_a_cohort_smaller_than_the_ranks(ranks, jax_fedavg, name):
    """1 client over 2 and 4 ranks, 3 (int8) over 4: some ranks hold only
    padding slots, which must change nothing."""
    n = 1 if name == "small" else 3
    for world in (2, 4):
        if n >= world:
            continue
        got = ranks[world][0][0]["runs"][name][0]
        _close(got["params"], jax_fedavg[name]["params"], 1e-5)
        np.testing.assert_allclose(got["losses"],
                                   jax_fedavg[name]["losses"], rtol=1e-4)


_JAX_SHARDED = r"""
import functools
import sys
import jax
import jax.experimental.shard_map as shmap
import numpy as np
# this JAX's shard_map checks that a scan carry's varying mesh axes match,
# which the reference's cohort scan (written for an older JAX) fails; the
# check only types the program, so it is turned off here, outside the
# package
shmap.shard_map = functools.partial(shmap.shard_map, check_rep=False)
from repro.configs.paper_models import MLPConfig
from repro.data.synthetic import DataSpec, make_dataset
from repro.models import build_model
from repro.optim.optimizers import get_optimizer
from repro.runtime import sharded_fedavg_train
assert jax.device_count() == 4, jax.devices()
spec, cids = eval(sys.argv[2]), eval(sys.argv[3])
ds = make_dataset(DataSpec(**spec))
model = build_model(MLPConfig(name="mlp_shard", in_dim=12, hidden=(16,),
                              n_classes=4))
params = model.init(jax.random.PRNGKey(0))
data = [ds.client_data(c) for c in cids]
out = {}
for comp in (None, "int8"):
    res = sharded_fedavg_train(
        model, params, data, passes=2.0, batch_size=4,
        optimizer=get_optimizer("sgd", 0.05, momentum=0.9),
        rng=np.random.default_rng(42), compression=comp)
    for i, leaf in enumerate(jax.tree.leaves(res.params)):
        out[f"{comp}_{i}"] = np.asarray(leaf)
np.savez(sys.argv[1], **out)
"""


def test_matches_the_reference_sharded_path(ranks, tmp_path):
    """The JAX package's own ``sharded_fedavg_train`` on 4 XLA CPU devices
    (a subprocess, nothing in the package changed; ``shard_map``'s type
    check off, see the script) against the port's D=4 ranks."""
    out = tmp_path / "reference.npz"
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_SHARDED, str(out), repr(SPEC),
         repr(CIDS)], env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = np.load(out)
    for comp in COMPS:
        got = ranks[4][0][0]["runs"][f"cohort_{comp}"][0]["params"]
        _close(got, [want[f"{comp}_{i}"] for i in range(len(got))], 1e-5)


# ---------------------------------------------------------------------------
# the sharded trial, sweep and evaluation
# ---------------------------------------------------------------------------

def test_sharded_trial_matches_jax_batched_trial(ranks, p0):
    import jax
    import jax.numpy as jnp
    from repro.configs.paper_models import MLPConfig as JMLPConfig
    from repro.core import CostModel as JCostModel
    from repro.core import FedTune as JFedTune
    from repro.core import FedTuneConfig as JFedTuneConfig
    from repro.core import Preference as JPreference
    from repro.core.tuner import HyperParams as JHyperParams
    from repro.data.synthetic import DataSpec as JDataSpec
    from repro.data.synthetic import make_dataset as j_make_dataset
    from repro.federated import FLConfig as JFLConfig
    from repro.federated import FLServer as JFLServer
    from repro.federated import get_aggregator as j_get_aggregator
    from repro.models import build_model as j_build_model
    from repro.optim.optimizers import get_optimizer as j_get_optimizer
    from repro.runtime import RuntimeConfig as JRuntimeConfig
    want = JFLServer(
        j_build_model(JMLPConfig(name="mlp_shard", in_dim=12, hidden=(16,),
                                 n_classes=4)),
        j_make_dataset(JDataSpec(**SPEC)), j_get_aggregator("fedavg"),
        j_get_optimizer("sgd", 0.05, momentum=0.9),
        JCostModel(flops_per_example=2 * N_PARAMS, param_count=N_PARAMS),
        JFLConfig(m=5, e=2.0, batch_size=4, target_accuracy=0.99,
                  max_rounds=4, eval_points=128),
        tuner=JFedTune(JFedTuneConfig(preference=JPreference(*PREF)),
                       JHyperParams(5, 2.0)),
        runtime_config=JRuntimeConfig(mode="sync", client_exec="batched"),
    ).run(jax.tree.map(jnp.asarray, p0))
    results = ranks[2][0]
    got = results[0]["trial"]
    assert got["client_exec"] == "sharded" and got["sharded_rounds"] == 4
    assert got["m_e"] == [(h.m, h.e) for h in want.history]
    assert got["cost"] == list(want.total_cost.as_tuple())
    np.testing.assert_allclose(got["acc"], [h.accuracy for h in want.history],
                               atol=1e-5, rtol=0)
    _close(got["params"], [np.asarray(x) for x in jax.tree.leaves(
        want.params)], 1e-4)
    other = results[1]["trial"]
    assert other["acc"] == got["acc"] and other["cost"] == got["cost"]
    assert _bitwise(other["params"], got["params"])


def test_sharded_sweep_matches_the_batched_pack(ranks):
    results, store = ranks[2]
    want = {r.spec.key(): r.to_record() for r in run_sweep(
        _sweep_specs(), pack="batched", device="cpu")}
    rows = ResultStore(store).load()
    assert sorted(r["key"] for r in rows) == sorted(want)  # once, rank 0
    for res in results:
        assert res["sweep"]["sharded_rounds"] == 3      # one group a round
        got = {r["key"]: r for r in res["sweep"]["records"]}
        for key, w in want.items():
            g = got[key]
            assert g["engine"] == "vectorized/sharded"
            assert (g["history_m"], g["history_e"]) == (w["history_m"],
                                                        w["history_e"])
            assert g["cost"] == w["cost"] and g["rounds"] == w["rounds"]
            np.testing.assert_allclose(g["history_acc"], w["history_acc"],
                                       atol=1e-5, rtol=0)
    rows_by_key = {r["key"]: r for r in rows}
    for r in results[1]["sweep"]["records"]:
        assert r["history_acc"] == rows_by_key[r["key"]]["history_acc"]


def test_stacked_evaluation_over_ranks_equals_the_unsharded_call(ranks):
    srv, lanes = _eval_lanes()
    want = StackedEvaluator(srv.model, srv.dataset, 128,
                            "cpu").evaluate(lanes)
    assert len(lanes) % 2 == 1
    for res in ranks[2][0]:
        assert res["eval"]["mesh"] == want
        assert res["eval"]["mesh_pad8"] == want
        assert res["eval"]["plain"] == want


# ---------------------------------------------------------------------------
# one process: the mesh's pieces and the fallbacks
# ---------------------------------------------------------------------------

def test_backend_rule_blocks_and_the_rank_order_fold():
    assert mesh_mod.pick_backend("cpu", 4) == "gloo"
    assert mesh_mod.pick_backend("cuda", 2, n_cuda=1) == "gloo"
    assert mesh_mod.pick_backend("cuda", 2, n_cuda=2) == "nccl"
    assert mesh_mod.pick_backend("cuda", 1, n_cuda=1) == "nccl"
    mesh = mesh_mod.make_clients_mesh()
    assert (mesh.size, mesh.rank, mesh.backend) == (1, 0, None)
    assert mesh.axis_names == ("clients",)
    assert mesh.block(6) == slice(0, 6)
    four = mesh_mod.ClientsMesh(None, 2, 4, "gloo", torch.device("cpu"))
    assert four.block(8) == slice(4, 6)
    with pytest.raises(ValueError, match="do not split"):
        four.block(6)
    parts = torch.tensor([[1e8, 1.0], [1.0, 1e8], [-1e8, -1e8]],
                         dtype=torch.float32)
    assert mesh_mod.fold(parts).tolist() == [0.0, 0.0]   # ((a+b)+c)
    x = torch.arange(3.0)
    assert torch.equal(mesh_mod.fold(mesh.gather(x)), x)


def test_one_process_sharded_requests_fall_back_to_batched(capsys, p0):
    """No process group: a sharded trial prints the reference's fallback
    and runs batched; a direct ``sharded_fedavg_train`` runs over a mesh of
    one rank and gives the batched FedAvg."""
    eng = EventDrivenRuntime(_server("sharded"),
                             config=RuntimeConfig(client_exec="sharded"))
    assert eng.client_exec == "batched"
    assert "falling back to batched" in capsys.readouterr().out
    for agg, mode, want in (("fednova", "sync", "batched"),
                            ("fedavg", "async", "sequential")):
        srv = _server("sharded", aggregator=agg, mode=mode)
        assert EventDrivenRuntime(srv, config=srv.runtime_config
                                  ).client_exec == want
    name, data, passes, comp = _cohorts()[1]
    params = params_from_numpy(p0, "cpu")
    one = sharded_fedavg_train(_model(), params, data, passes=passes,
                               batch_size=4, optimizer=_optimizer(),
                               rng=np.random.default_rng(42),
                               compression=comp)
    upd = batched_local_train(_model(), params, data, passes=passes,
                              batch_size=4, optimizer=_optimizer(),
                              rng=np.random.default_rng(42),
                              compression=comp)
    _close(leaves(one.params),
           leaves(get_aggregator("fedavg")(params, upd)), 1e-5)
