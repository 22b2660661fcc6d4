"""The port's MLP, loss and parameter carriage against the JAX reference.

The reference's initial params are carried across with
``repro_torch.weights``.  Forward and loss agree within rtol=1e-5,
atol=1e-6: XLA and PyTorch sum the matmuls in different orders.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.paper_models import MLP_EMNIST as J_MLP_EMNIST  # noqa: E402
from repro.configs.paper_models import MLPConfig as JMLPConfig  # noqa: E402
from repro.federated.aggregation import _flatten as j_flatten  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro_torch.configs.paper_models import (MLP_EMNIST, MLPConfig,  # noqa: E402
                                              RESNET10)
from repro_torch.federated.aggregation import _flatten  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402
from repro_torch.weights import params_from_numpy, params_to_numpy  # noqa: E402

CONFIGS = [(JMLPConfig(name="mlp_t", in_dim=12, hidden=(16,), n_classes=4),
            MLPConfig(name="mlp_t", in_dim=12, hidden=(16,), n_classes=4)),
           (J_MLP_EMNIST, MLP_EMNIST)]


def _pair(i, seed=0):
    jcfg, tcfg = CONFIGS[i]
    jm, tm = j_build_model(jcfg), build_model(tcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu",
                           template=tm.init(seed, "cpu"))
    return jcfg, jm, jp, tm, tp


@pytest.mark.parametrize("i", [0, 1])
def test_mlp_forward_and_loss_match_reference(i):
    jcfg, jm, jp, tm, tp = _pair(i)
    rng = np.random.default_rng(i)
    x = rng.standard_normal((10, jcfg.in_dim)).astype(np.float32)
    y = rng.integers(0, jcfg.n_classes, 10).astype(np.int32)
    mask = np.arange(10) < 7                     # a padded batch
    want = np.asarray(jm.forward(jp, jnp.asarray(x)))
    got = tm.forward(tp, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    for m in (None, mask):
        jb = {"x": jnp.asarray(x), "y": jnp.asarray(y)}
        tb = {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}
        if m is not None:
            jb["mask"], tb["mask"] = jnp.asarray(m), torch.from_numpy(m)
        jl, jmet = jm.loss_fn(jp, jb)
        tl, tmet = tm.loss_fn(tp, tb)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5,
                                   atol=1e-6)
        assert float(tmet["acc"]) == float(jmet["acc"])


def test_param_leaves_follow_jax_flatten_order():
    """Sorted dict keys: each layer flattens ``b`` before ``w``."""
    _, _, jp, _, tp = _pair(0)
    jl = [np.asarray(a) for a in jax.tree.leaves(jp)]
    tl = [t.numpy() for t in leaves(tp)]
    assert [a.shape for a in jl] == [a.shape for a in tl]
    assert tl[0].shape == (16,) and tl[1].shape == (12, 16)
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(_flatten(tp)[0].numpy(),
                                  np.asarray(j_flatten(jp)[0]))


def test_weights_round_trip_and_checks():
    _, _, jp, tm, tp = _pair(0)
    back = params_to_numpy(tp)
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), b)
    bad = jax.tree.map(np.asarray, jp)
    bad["layers"][0]["w"] = bad["layers"][0]["w"][:, :3]
    with pytest.raises(ValueError, match="leaf 1"):
        params_from_numpy(bad, "cpu", template=tm.init(0, "cpu"))
    f64 = jax.tree.map(lambda a: np.asarray(a, np.float64), jp)
    with pytest.raises(ValueError, match="float64"):
        params_from_numpy(f64, "cpu", template=tm.init(0, "cpu"))


def test_init_is_seeded_and_device_independent():
    tm = build_model(MLP_EMNIST)
    a, b = tm.init(3, "cpu"), tm.init(3, "cpu")
    for x, y in zip(leaves(a), leaves(b)):
        assert torch.equal(x, y)
    assert sum(t.numel() for t in leaves(a)) == 169_462
    c = tm.init(4, "cpu")
    assert not torch.equal(leaves(a)[1], leaves(c)[1])


def test_unported_configs_raise():
    with pytest.raises(NotImplementedError, match="ResNet"):
        build_model(RESNET10)
