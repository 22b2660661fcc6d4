"""Reduced FedTune trials through the port against the JAX reference.

Both packages start from the reference's initial params (carried across by
``repro_torch.weights``) on the same federation, fleet and seeds, with
FedTune on.  Per mode (sync, async, buffered) they must give identical
(M, E) per round, identical cost totals, identical dispatch and staleness
logs (async/buffered), and accuracy within 0.01 per round.  Inside the
port, sync mode over a homogeneous fleet equals ``run_legacy`` bit for bit
(as tests/test_runtime.py pins for the reference).
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402

from repro.configs.paper_models import MLPConfig as JMLPConfig  # noqa: E402
from repro.core import CostModel as JCostModel  # noqa: E402
from repro.core import FedTune as JFedTune  # noqa: E402
from repro.core import FedTuneConfig as JFedTuneConfig  # noqa: E402
from repro.core import Preference as JPreference  # noqa: E402
from repro.core.tuner import HyperParams as JHyperParams  # noqa: E402
from repro.data.synthetic import DataSpec as JDataSpec  # noqa: E402
from repro.data.synthetic import make_dataset as j_make_dataset  # noqa: E402
from repro.federated import FLConfig as JFLConfig  # noqa: E402
from repro.federated import FLServer as JFLServer  # noqa: E402
from repro.federated import get_aggregator as j_get_aggregator  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.optim.optimizers import get_optimizer as j_get_optimizer  # noqa: E402
from repro.runtime import RuntimeConfig as JRuntimeConfig  # noqa: E402
from repro.runtime import sample_fleet as j_sample_fleet  # noqa: E402
from repro_torch.configs.paper_models import MLPConfig  # noqa: E402
from repro_torch.core import CostModel, FedTune, FedTuneConfig, Preference  # noqa: E402
from repro_torch.core.tuner import HyperParams  # noqa: E402
from repro_torch.data.synthetic import DataSpec, make_dataset  # noqa: E402
from repro_torch.federated import FLConfig, FLServer, get_aggregator  # noqa: E402
from repro_torch.launch import train as t_train  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim.optimizers import get_optimizer  # noqa: E402
from repro_torch.runtime import RuntimeConfig, sample_fleet  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402
from repro_torch.weights import params_from_numpy  # noqa: E402

SPEC = dict(name="trial_test", n_classes=4, shape=(12,), n_train_clients=24,
            n_test_clients=8, size_log_mean=2.5, size_log_std=0.5, seed=1)
N_PARAMS = 12 * 16 + 16 + 16 * 4 + 4
PREF = (0.25, 0.25, 0.25, 0.25)


def _fl_kwargs(max_rounds, m, e):
    return dict(m=m, e=e, batch_size=4, target_accuracy=0.99,
                max_rounds=max_rounds, eval_points=128)


def j_server(mode, het, max_rounds, m=5, e=2.0, buffer_k=3):
    model = j_build_model(JMLPConfig(name="mlp", in_dim=12, hidden=(16,),
                                     n_classes=4))
    fleet = None if het is None else j_sample_fleet(het, 24, seed=3)
    return JFLServer(
        model, j_make_dataset(JDataSpec(**SPEC)), j_get_aggregator("fedavg"),
        j_get_optimizer("sgd", 0.05, momentum=0.9),
        JCostModel(flops_per_example=2 * N_PARAMS, param_count=N_PARAMS),
        JFLConfig(**_fl_kwargs(max_rounds, m, e)),
        tuner=JFedTune(JFedTuneConfig(preference=JPreference(*PREF)),
                       JHyperParams(m, e)),
        fleet=fleet, runtime_config=JRuntimeConfig(mode=mode,
                                                   buffer_k=buffer_k))


def t_server(mode, het, max_rounds, m=5, e=2.0, buffer_k=3, tuner=True):
    model = build_model(MLPConfig(name="mlp", in_dim=12, hidden=(16,),
                                  n_classes=4))
    fleet = None if het is None else sample_fleet(het, 24, seed=3)
    return FLServer(
        model, make_dataset(DataSpec(**SPEC)), get_aggregator("fedavg"),
        get_optimizer("sgd", 0.05, momentum=0.9),
        CostModel(flops_per_example=2 * N_PARAMS, param_count=N_PARAMS),
        FLConfig(**_fl_kwargs(max_rounds, m, e)),
        tuner=(FedTune(FedTuneConfig(preference=Preference(*PREF)),
                       HyperParams(m, e)) if tuner else None),
        fleet=fleet, runtime_config=RuntimeConfig(mode=mode,
                                                  buffer_k=buffer_k),
        device="cpu")


def _initial_params():
    model = j_build_model(JMLPConfig(name="mlp", in_dim=12, hidden=(16,),
                                     n_classes=4))
    return jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0)))


@pytest.mark.parametrize("mode,het,rounds", [("sync", None, 6),
                                             ("sync", "stragglers", 5),
                                             ("async", "stragglers", 10),
                                             ("buffered", "mild", 4)])
def test_trial_matches_reference(mode, het, rounds):
    p0 = _initial_params()
    want = j_server(mode, het, rounds).run(jax.tree.map(jax.numpy.asarray,
                                                        p0))
    got = t_server(mode, het, rounds).run(params_from_numpy(p0, "cpu"))
    assert got.rounds == want.rounds == rounds
    assert [(h.m, h.e) for h in got.history] == \
        [(h.m, h.e) for h in want.history]
    assert (got.final_m, got.final_e) == (want.final_m, want.final_e)
    assert got.total_cost.as_tuple() == want.total_cost.as_tuple()
    assert [h.sim_time for h in got.history] == \
        [h.sim_time for h in want.history]
    assert got.dispatch_log == want.dispatch_log
    assert got.staleness_log == want.staleness_log
    np.testing.assert_allclose([h.accuracy for h in got.history],
                               [h.accuracy for h in want.history], atol=0.01)
    # the decisions above did move: FedTune changed (M, E) at least once
    assert len({(h.m, h.e) for h in want.history}) > 1 or mode == "buffered"


def test_sync_homogeneous_equals_legacy_bitwise():
    p0 = _initial_params()
    legacy = t_server("sync", None, 4).run_legacy(
        params_from_numpy(p0, "cpu"))
    sync = t_server("sync", None, 4).run(params_from_numpy(p0, "cpu"))
    assert [h.accuracy for h in legacy.history] == \
        [h.accuracy for h in sync.history]
    assert legacy.total_cost.as_tuple() == sync.total_cost.as_tuple()
    for a, b in zip(leaves(legacy.params), leaves(sync.params)):
        assert torch.equal(a, b)
    assert all(h.n_updates == h.m for h in sync.history)


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    """No device given means cuda; without a GPU that raises instead of
    quietly running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = build_model(MLPConfig(name="mlp", in_dim=12, hidden=(16,),
                                  n_classes=4))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FLServer(model, make_dataset(DataSpec(**SPEC)),
                 get_aggregator("fedavg"), get_optimizer("sgd", 0.05),
                 CostModel(flops_per_example=1.0, param_count=1.0),
                 FLConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_train.main(["--rounds", "1"])


def test_params_on_another_device_are_refused():
    srv = t_server("sync", None, 1)
    p = params_from_numpy(_initial_params(), "meta")
    with pytest.raises(ValueError, match="server runs on cpu"):
        srv.run(p)


def test_unported_paths_raise(capsys):
    """``client_exec="sharded"`` in one process (no process group) prints
    the reference's fallback and gives the batched run's records; the
    LM half's ``--mode mesh`` still raises."""
    runs = {}
    for exec_ in ("batched", "sharded"):
        srv = t_server("sync", None, 3)
        srv.runtime_config = RuntimeConfig(client_exec=exec_)
        runs[exec_] = srv.run(params_from_numpy(_initial_params(), "cpu"))
    assert "sharded execution needs a process group" in \
        capsys.readouterr().out
    want, got = runs["batched"], runs["sharded"]
    assert [(h.m, h.e, h.accuracy) for h in got.history] == \
        [(h.m, h.e, h.accuracy) for h in want.history]
    assert got.total_cost.as_tuple() == want.total_cost.as_tuple()
    for a, b in zip(leaves(got.params), leaves(want.params)):
        assert torch.equal(a, b)
    with pytest.raises(NotImplementedError, match="not ported"):
        t_train.main(["--mode", "mesh", "--device", "cpu"])


def test_launcher_trace_and_checkpoint(tmp_path):
    """``--trace`` writes a schema-valid dual-clock trace and its metrics;
    ``--checkpoint`` saves the final params, which load back bitwise."""
    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.obs.export import validate_chrome_trace
    trace = tmp_path / "run.trace.json"
    res = t_train.main(["--rounds", "2", "--m", "3", "--e", "1",
                        "--device", "cpu", "--trace", str(trace),
                        "--checkpoint", str(tmp_path / "ck" / "x")])
    events = json.loads(trace.read_text())["traceEvents"]
    assert validate_chrome_trace({"traceEvents": events}) == []
    assert sum(ev["name"] == "round" and ev["ph"] == "X"
               for ev in events) >= 2
    assert (tmp_path / "run.metrics.jsonl").exists()
    got, meta = load_checkpoint(str(tmp_path / "ck" / "x"), res.params)
    assert meta["step"] == 2
    for a, b in zip(leaves(got), leaves(res.params)):
        assert torch.equal(a, b)


def test_launcher_runs_on_cpu(capsys):
    res = t_train.main(["--rounds", "2", "--m", "3", "--e", "1",
                        "--fedtune", "--runtime", "async", "--het", "mild",
                        "--device", "cpu"])
    assert res.rounds == 2
    assert all(t.device.type == "cpu" for t in leaves(res.params))
    assert "device=cpu" in capsys.readouterr().out
