"""The port's client training, compression and aggregators against the
JAX reference on identical inputs.

Tolerances: one ``local_train`` gives the same ``n_steps`` (and consumes
the numpy rng identically) with params within atol=1e-4; FedAvg and the
FedBuff flush are bitwise (the same ``fed_reduce`` arithmetic); FedNova,
the adaptive servers and the FedAsync mix agree within rtol=1e-6;
``compress_delta`` agrees element by element.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.paper_models import MLPConfig as JMLPConfig  # noqa: E402
from repro.data.synthetic import DataSpec as JDataSpec  # noqa: E402
from repro.data.synthetic import make_dataset as j_make_dataset  # noqa: E402
from repro.federated import aggregation as jagg  # noqa: E402
from repro.federated.client import local_train as j_local_train  # noqa: E402
from repro.federated.compression import compress_delta as j_compress  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.optim.optimizers import get_optimizer as j_get_optimizer  # noqa: E402
from repro_torch.configs.paper_models import MLPConfig  # noqa: E402
from repro_torch.data.synthetic import DataSpec, make_dataset  # noqa: E402
from repro_torch.federated import aggregation as tagg  # noqa: E402
from repro_torch.federated.client import local_train  # noqa: E402
from repro_torch.federated.compression import compress_delta  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim.optimizers import get_optimizer  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402
from repro_torch.weights import params_from_numpy  # noqa: E402

SPEC = dict(name="fed_test", n_classes=4, shape=(12,), n_train_clients=24,
            n_test_clients=8, size_log_mean=2.5, size_log_std=0.5, seed=1)


def _np_tree(jtree):
    return jax.tree.map(np.asarray, jtree)


def _t_tree(nptree):
    return params_from_numpy(nptree, "cpu")


def _j_tree(nptree):
    return jax.tree.map(jnp.asarray, nptree)


def _assert_trees(ttree, jtree, **tol):
    jl = [np.asarray(a) for a in jax.tree.leaves(jtree)]
    tl = [t.detach().numpy() for t in leaves(ttree)]
    assert len(jl) == len(tl)
    for a, b in zip(tl, jl):
        if tol:
            np.testing.assert_allclose(a, b, **tol)
        else:
            np.testing.assert_array_equal(a, b)


def _models():
    jm = j_build_model(JMLPConfig(name="m", in_dim=12, hidden=(16,),
                                  n_classes=4))
    tm = build_model(MLPConfig(name="m", in_dim=12, hidden=(16,),
                               n_classes=4))
    return jm, tm


def _random_tree(rng, scale=1.0):
    """A params-shaped numpy tree (12 -> 16 -> 4 MLP)."""
    return {"layers": [
        {"w": (rng.standard_normal((12, 16)) * scale).astype(np.float32),
         "b": (rng.standard_normal(16) * scale).astype(np.float32)},
        {"w": (rng.standard_normal((16, 4)) * scale).astype(np.float32),
         "b": (rng.standard_normal(4) * scale).astype(np.float32)}]}


def _client_trees(seed, k):
    rng = np.random.default_rng(seed)
    g = _random_tree(rng)
    clients = [jax.tree.map(lambda a: a + 0.1 * rng.standard_normal(
        a.shape).astype(np.float32), g) for _ in range(k)]
    return g, clients


@pytest.mark.parametrize("opt,prox_mu", [("sgd", 0.0), ("sgd", 0.1),
                                         ("adam", 0.0)])
def test_local_train_matches_reference(opt, prox_mu):
    jm, tm = _models()
    jds, tds = j_make_dataset(JDataSpec(**SPEC)), make_dataset(DataSpec(**SPEC))
    x, y = jds.client_data(5)
    tx, ty = tds.client_data(5)
    np.testing.assert_array_equal(x, tx)
    np.testing.assert_array_equal(y, ty)
    p0 = _np_tree(jm.init(jax.random.PRNGKey(0)))
    kw = {"momentum": 0.9} if opt == "sgd" else {}
    jr, tr = np.random.default_rng(7), np.random.default_rng(7)
    jup = j_local_train(jm, _j_tree(p0), x, y, passes=2.5, batch_size=4,
                        optimizer=j_get_optimizer(opt, 0.05, **kw), rng=jr,
                        prox_mu=prox_mu)
    tup = local_train(tm, _t_tree(p0), tx, ty, passes=2.5, batch_size=4,
                      optimizer=get_optimizer(opt, 0.05, **kw), rng=tr,
                      prox_mu=prox_mu)
    assert tup.n_steps == jup.n_steps > 0
    assert tup.n_examples == jup.n_examples
    assert jr.random() == tr.random()          # the same rng consumption
    _assert_trees(tup.params, jup.params, atol=1e-4, rtol=0)
    assert tup.last_loss == pytest.approx(jup.last_loss, rel=1e-4, abs=1e-5)


def test_compress_delta_matches_element_by_element():
    rng = np.random.default_rng(3)
    g = _random_tree(rng)
    c = jax.tree.map(lambda a: a + 0.05 * rng.standard_normal(
        a.shape).astype(np.float32), g)
    c["layers"][1]["b"] = g["layers"][1]["b"].copy()      # an all-zero delta
    want = j_compress(_j_tree(g), _j_tree(c))
    got = compress_delta(_t_tree(g), _t_tree(c))
    _assert_trees(got, want)
    assert compress_delta(_t_tree(g), _t_tree(c), None)["layers"][0]["w"] \
        .equal(_t_tree(c)["layers"][0]["w"])
    with pytest.raises(ValueError, match="valid methods"):
        compress_delta(_t_tree(g), _t_tree(c), "int4")


def _updates(mod, trees, to_tree):
    counts = [7, 13, 4, 21]
    steps = [3, 5, 1, 8]
    return [mod.ClientUpdate(params=to_tree(t), n_examples=n, n_steps=s)
            for t, n, s in zip(trees, counts, steps)]


def test_fedavg_is_bitwise():
    g, clients = _client_trees(11, 4)
    want = jagg.FedAvg()(_j_tree(g), _updates(jagg, clients, _j_tree))
    got = tagg.FedAvg()(_t_tree(g), _updates(tagg, clients, _t_tree))
    _assert_trees(got, want)


@pytest.mark.parametrize("name", ["fednova", "fedadagrad", "fedadam",
                                  "fedyogi"])
def test_other_aggregators_match(name):
    """Two rounds, so the adaptive servers' moment state is exercised."""
    g, clients = _client_trees(12, 4)
    jag, tag = jagg.get_aggregator(name), tagg.get_aggregator(name)
    jg, tg = _j_tree(g), _t_tree(g)
    for _ in range(2):
        jg = jag(jg, _updates(jagg, clients, _j_tree))
        tg = tag(tg, _updates(tagg, clients, _t_tree))
        _assert_trees(tg, jg, rtol=1e-6, atol=1e-7)


def test_fedbuff_flush_is_bitwise():
    g, deltas = _client_trees(13, 3)
    jb = jagg.FedBuffAggregator(buffer_k=3, server_lr=0.7)
    tb = tagg.FedBuffAggregator(buffer_k=3, server_lr=0.7)
    for i, d in enumerate(deltas):
        jb.add(_j_tree(d), staleness=i)
        tb.add(_t_tree(d), staleness=i)
    assert tb.full and jb.full
    _assert_trees(tb.flush(_t_tree(g)), jb.flush(_j_tree(g)))
    assert len(tb) == 0
    with pytest.raises(RuntimeError, match="empty"):
        tb.flush(_t_tree(g))


@pytest.mark.parametrize("staleness", [0, 3])
def test_async_mix_matches(staleness):
    g, (c,) = _client_trees(14, 1)
    want = jagg.apply_async_update(_j_tree(g), _j_tree(c), mix=0.6,
                                   staleness=staleness)
    got = tagg.apply_async_update(_t_tree(g), _t_tree(c), mix=0.6,
                                  staleness=staleness)
    _assert_trees(got, want, rtol=1e-6, atol=1e-7)


def test_staleness_weight_is_the_reference_function():
    for kind in ("polynomial", "constant", "hinge"):
        for s in (0, 1, 2, 5, 9):
            assert tagg.staleness_weight(s, 0.5, kind) == \
                jagg.staleness_weight(s, 0.5, kind)
    with pytest.raises(KeyError):
        tagg.staleness_weight(1, kind="nope")
