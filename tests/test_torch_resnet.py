"""The port's ResNets and the speech-command FedTune experiment against the
JAX reference on identical numpy inputs.

The reference's initial params are carried across with
``repro_torch.weights`` (HWIO convolution leaves, no transposes).
Tolerances: forward and loss within 2e-5 (XLA's and PyTorch's CPU
convolutions sum in different orders); gradients within 1e-4 of each
leaf's max-abs; one ``local_train`` within 1e-4, as the MLP's
(tests/test_torch_federated.py); a batched cohort within 1e-5 of the
sequential loop (ROADMAP.md section 3, departure 5); ``compress_delta``
bitwise; reduced FedTune trials with the same (M, E), costs and logs and
accuracy within 0.01.  The images are 16x16 (15x15 for the odd ``SAME``
case): the widths and depths are Table 2's.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import paper_models as jpm  # noqa: E402
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
from repro.federated.aggregation import _flatten as j_flatten  # noqa: E402
from repro.federated.client import local_train as j_local_train  # noqa: E402
from repro.federated.compression import compress_delta as j_compress  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.models import resnet as j_resnet  # noqa: E402
from repro.optim.optimizers import get_optimizer as j_get_optimizer  # noqa: E402
from repro.runtime import RuntimeConfig as JRuntimeConfig  # noqa: E402
from repro.runtime import sample_fleet as j_sample_fleet  # noqa: E402
from repro_torch.configs import paper_models as tpm  # noqa: E402
from repro_torch.core import CostModel, FedTune, FedTuneConfig, Preference  # noqa: E402
from repro_torch.core.tuner import HyperParams  # noqa: E402
from repro_torch.data.synthetic import DataSpec, make_dataset  # noqa: E402
from repro_torch.federated import FLConfig, FLServer, get_aggregator  # noqa: E402
from repro_torch.federated.aggregation import _flatten  # noqa: E402
from repro_torch.federated.client import local_train  # noqa: E402
from repro_torch.federated.compression import compress_delta  # noqa: E402
from repro_torch.launch import fedtune_speech  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import resnet as t_resnet  # noqa: E402
from repro_torch.optim.optimizers import get_optimizer  # noqa: E402
from repro_torch.runtime import RuntimeConfig, sample_fleet  # noqa: E402
from repro_torch.runtime.batched import batched_local_train  # noqa: E402
from repro_torch.tree import leaves, unflatten_like  # noqa: E402
from repro_torch.weights import params_from_numpy, params_to_numpy  # noqa: E402

# (name, blocks per stage, in_channels, n_classes): Table 2's four models
# in the speech shape and ResNet-10 in CIFAR-100's
MODELS = {"resnet10": ((1, 1, 1, 1), 1, 35),
          "resnet18": ((2, 2, 2, 2), 1, 35),
          "resnet26": ((3, 3, 3, 3), 1, 35),
          "resnet34": ((3, 4, 6, 3), 1, 35),
          "resnet10_cifar": ((1, 1, 1, 1), 3, 100)}
# Table 2's parameter counts (the reference's tree at 1 channel, 35 classes)
TABLE2_PARAMS = {"resnet10": 79_259, "resnet18": 177_659,
                 "resnet26": 276_059, "resnet34": 336_411}


def _configs(name, image_size=16):
    blocks, ch, n_cls = MODELS[name]
    return tuple(dataclasses.replace(
        pm.resnet(name, blocks, n_classes=n_cls, in_channels=ch),
        image_size=image_size) for pm in (jpm, tpm))


@functools.lru_cache(maxsize=None)
def _pair(name, image_size=16):
    """Both packages' models, the reference's init as numpy, the port's
    params carried across from it."""
    jcfg, tcfg = _configs(name, image_size)
    jm, tm = j_build_model(jcfg), build_model(tcfg)
    p0 = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    tp = params_from_numpy(p0, "cpu", template=tm.init(0, "cpu"))
    return jm, tm, p0, tp


def _batch(name, n=4, size=16, seed=0):
    _, ch, n_cls = MODELS[name]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, size, size, ch)).astype(np.float32)
    y = rng.integers(0, n_cls, n).astype(np.int32)
    return x, y


@pytest.mark.parametrize("name", list(MODELS))
def test_forward_and_loss_match_reference(name):
    jm, tm, p0, tp = _pair(name)
    x, y = _batch(name, n=6)
    mask = np.arange(6) < 4                      # a padded client batch
    want = np.asarray(jm.forward(jax.tree.map(jnp.asarray, p0),
                                 jnp.asarray(x)))
    got = tm.forward(tp, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    for m in (None, mask):
        jb = {"x": jnp.asarray(x), "y": jnp.asarray(y)}
        tb = {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}
        if m is not None:
            jb["mask"], tb["mask"] = jnp.asarray(m), torch.from_numpy(m)
        jl, jmet = jm.loss_fn(jax.tree.map(jnp.asarray, p0), jb)
        tl, tmet = tm.loss_fn(tp, tb)
        np.testing.assert_allclose(float(tl), float(jl), rtol=2e-5,
                                   atol=2e-5)
        assert float(tmet["acc"]) == float(jmet["acc"])


@pytest.mark.parametrize("size,pads", [(15, (1, 1)), (16, (0, 1))])
def test_same_padding_at_stride_2_matches_xla(size, pads):
    """XLA's ``SAME`` pads a 3x3 stride-2 convolution (0, 1) on an even
    size and (1, 1) on an odd one; a 1x1 one not at all.  Each convolution
    alone, then the whole ResNet-10 at that image size."""
    assert t_resnet.same_pads(size, 3, 2) == pads
    assert t_resnet.same_pads(size, 1, 2) == (0, 0)
    assert t_resnet.same_pads(size, 3, 1) == (1, 1)
    rng = np.random.default_rng(size)
    x = rng.standard_normal((2, size, size, 8)).astype(np.float32)
    for k in (3, 1):
        w = rng.standard_normal((k, k, 8, 16)).astype(np.float32)
        want = np.asarray(j_resnet._conv(jnp.asarray(x), jnp.asarray(w), 2))
        got = t_resnet._conv(torch.from_numpy(x).permute(0, 3, 1, 2)
                             .contiguous(), torch.from_numpy(w), 2)
        got = got.permute(0, 2, 3, 1).numpy()
        assert got.shape == want.shape == (2, -(-size // 2),
                                           -(-size // 2), 16)
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    jm, tm, p0, tp = _pair("resnet10")
    xs, _ = _batch("resnet10", n=3, size=size, seed=size)
    want = np.asarray(jm.forward(jax.tree.map(jnp.asarray, p0),
                                 jnp.asarray(xs)))
    got = tm.forward(tp, torch.from_numpy(xs)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("c", [8, 12, 64])
def test_groupnorm_matches_reference_and_batches(c):
    """The divisor rule (12 channels: 6 groups), the population variance,
    and the same result for each lane under ``torch.func.vmap``."""
    rng = np.random.default_rng(c)
    x = (rng.standard_normal((3, 5, 5, c)) * 3.0 + 1.0).astype(np.float32)
    s = rng.standard_normal(c).astype(np.float32)
    b = rng.standard_normal(c).astype(np.float32)
    want = np.asarray(j_resnet._groupnorm(jnp.asarray(x), jnp.asarray(s),
                                          jnp.asarray(b)))
    tx = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
    got = t_resnet._groupnorm(tx, torch.from_numpy(s), torch.from_numpy(b))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=2e-5, atol=2e-5)
    lanes = torch.stack([tx, tx * 2.0 - 1.0])
    ss = torch.stack([torch.from_numpy(s), torch.from_numpy(b)])
    out = torch.func.vmap(t_resnet._groupnorm)(lanes, ss, ss.flip(0))
    for i in range(2):
        torch.testing.assert_close(out[i], t_resnet._groupnorm(
            lanes[i], ss[i], ss.flip(0)[i]), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", list(MODELS))
def test_gradients_match_jax_grad(name):
    jm, tm, p0, tp = _pair(name)
    x, y = _batch(name, n=4, seed=1)
    jb = {"x": jnp.asarray(x), "y": jnp.asarray(y)}
    jg = jax.grad(lambda p: jm.loss_fn(p, jb)[0])(
        jax.tree.map(jnp.asarray, p0))
    ls = [t.detach().clone().requires_grad_(True) for t in leaves(tp)]
    loss, _ = tm.loss_fn(unflatten_like(tp, ls), {
        "x": torch.from_numpy(x), "y": torch.from_numpy(y)})
    grads = torch.autograd.grad(loss, ls)
    for i, (g, want) in enumerate(zip(grads, jax.tree.leaves(jg))):
        want = np.asarray(want)
        scale = max(float(np.abs(want).max()), 1e-30)
        err = float(np.abs(g.numpy() - want).max())
        assert err <= 1e-4 * scale, f"leaf {i}: {err} of max-abs {scale}"


@pytest.mark.parametrize("name", list(MODELS))
def test_leaves_follow_jax_flatten_order(name):
    """``head_b, head_w, stages[i][j]{conv1, conv2, gn1_b, gn1_s, gn2_b,
    gn2_s, proj}, stem, stem_gn_b, stem_gn_s``, HWIO convolutions; the
    flat rows equal the reference's element for element."""
    jm, tm, p0, tp = _pair(name)
    jl = jax.tree.leaves(p0)
    own = leaves(tm.init(5, "cpu"))
    assert [a.shape for a in jl] == [tuple(t.shape) for t in own] == \
        [tuple(t.shape) for t in leaves(tp)]
    blocks, ch, n_cls = MODELS[name]
    assert len(jl) == 5 + sum(blocks) * 6 + 3      # 3 projections
    assert jl[0].shape == (n_cls,) and jl[1].shape == (64, n_cls)
    assert jl[-3].shape == (3, 3, ch, 8)
    np.testing.assert_array_equal(_flatten(tp)[0].numpy(),
                                  np.asarray(j_flatten(p0)[0]))


def test_param_counts_and_flops_are_table_2s():
    for name, count in TABLE2_PARAMS.items():
        blocks, _, _ = MODELS[name]
        jcfg, tcfg = (pm.resnet(name, blocks) for pm in (jpm, tpm))
        tm, jm = build_model(tcfg), j_build_model(jcfg)
        shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
        assert sum(int(np.prod(s.shape)) for s in jax.tree.leaves(
            shapes)) == count
        assert sum(t.numel() for t in leaves(tm.init(0, "cpu"))) == count
        assert tm.flops_per_example == jm.flops_per_example
        assert tm.flops_per_example == \
            j_resnet.flops_per_example(jcfg) > 0
    for name in ("resnet10", "resnet18"):           # CIFAR-100's shape
        cfgs = [pm.resnet(name, MODELS[name][0], n_classes=100,
                          in_channels=3) for pm in (jpm, tpm)]
        assert build_model(cfgs[1]).flops_per_example == \
            j_build_model(cfgs[0]).flops_per_example


def test_weights_round_trip_and_init():
    jm, tm, p0, tp = _pair("resnet18")
    for a, b in zip(jax.tree.leaves(p0), jax.tree.leaves(
            params_to_numpy(tp))):
        np.testing.assert_array_equal(a, b)
    bad = jax.tree.map(lambda a: a, p0)
    bad["stem"] = np.transpose(p0["stem"], (3, 2, 0, 1))       # OIHW
    with pytest.raises(ValueError, match="leaf"):
        params_from_numpy(bad, "cpu", template=tm.init(0, "cpu"))
    a, b, c = (tm.init(s, "cpu") for s in (3, 3, 4))
    for x, y in zip(leaves(a), leaves(b)):
        assert torch.equal(x, y)
    assert not torch.equal(a["stem"], c["stem"])
    assert torch.equal(a["stages"][1][0]["gn1_s"], torch.ones(16))
    std = float(a["stages"][3][0]["conv2"].std())
    assert std == pytest.approx((2.0 / (9 * 64)) ** 0.5, rel=0.05)


SPEC = dict(name="speech_test", n_classes=10, shape=(16, 16, 1),
            n_train_clients=24, n_test_clients=8, size_log_mean=2.5,
            size_log_std=0.5, seed=1)


def _tiny_pair():
    """ResNet-10 sized for SPEC (16x16x1, 10 classes), both packages."""
    jcfg, tcfg = (dataclasses.replace(
        pm.resnet("resnet10", (1, 1, 1, 1), n_classes=10), image_size=16)
        for pm in (jpm, tpm))
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _tiny():
    jcfg, tcfg = _tiny_pair()
    jm, tm = j_build_model(jcfg), build_model(tcfg)
    p0 = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    return jm, tm, p0, j_get_optimizer("sgd", 0.05, momentum=0.9)


def test_local_train_matches_reference():
    jm, tm, p0, jopt = _tiny()
    jds, tds = j_make_dataset(JDataSpec(**SPEC)), make_dataset(DataSpec(**SPEC))
    x, y = jds.client_data(5)
    np.testing.assert_array_equal(x, tds.client_data(5)[0])
    jr, tr = np.random.default_rng(7), np.random.default_rng(7)
    jup = j_local_train(jm, jax.tree.map(jnp.asarray, p0), x, y, passes=2.0,
                        batch_size=5, optimizer=jopt, rng=jr)
    tup = local_train(tm, params_from_numpy(p0, "cpu"), x, y, passes=2.0,
                      batch_size=5,
                      optimizer=get_optimizer("sgd", 0.05, momentum=0.9),
                      rng=tr)
    assert tup.n_steps == jup.n_steps > 2
    assert jr.random() == tr.random()            # the same rng consumption
    for a, b in zip(leaves(tup.params), jax.tree.leaves(jup.params)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                                   rtol=0)
    assert tup.last_loss == pytest.approx(jup.last_loss, rel=1e-4, abs=1e-5)


def test_batched_cohort_matches_sequential():
    """A cohort through ``torch.func.vmap`` (the lanes' convolutions become
    one grouped convolution) against ``local_train`` client by client."""
    _, tm, p0, _ = _tiny()
    tds = make_dataset(DataSpec(**SPEC))
    cids = [4, 8, 14, 13]            # 6, 1, 2 and 5 steps: three buckets
    data = [tds.client_data(c) for c in cids]
    opt = get_optimizer("sgd", 0.05, momentum=0.9)
    tp = params_from_numpy(p0, "cpu")
    kw = dict(passes=1.0, batch_size=5, optimizer=opt)
    got = batched_local_train(tm, tp, data, rng=np.random.default_rng(3),
                              client_ids=cids, **kw)
    rng = np.random.default_rng(3)
    seq = [local_train(tm, tp, x, y, rng=rng, **kw) for x, y in data]
    assert sorted(u.n_steps for u in got) == [1, 2, 5, 6]
    for g, s in zip(got, seq):
        assert g.n_steps == s.n_steps
        assert g.last_loss == pytest.approx(s.last_loss, rel=1e-5)
        for a, b in zip(leaves(g.params), leaves(s.params)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5,
                                       rtol=0)


def test_compress_delta_is_bitwise_at_32_leaves():
    _, _, p0, _ = _tiny()
    rng = np.random.default_rng(11)
    c = jax.tree.map(lambda a: a + 0.02 * rng.standard_normal(
        a.shape).astype(np.float32), p0)
    c["stages"][2][0]["gn2_b"] = p0["stages"][2][0]["gn2_b"].copy()
    assert len(jax.tree.leaves(c)) == 32
    want = j_compress(jax.tree.map(jnp.asarray, p0),
                      jax.tree.map(jnp.asarray, c))
    got = compress_delta(params_from_numpy(p0, "cpu"),
                         params_from_numpy(c, "cpu"))
    for a, b in zip(leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


PREF = (0.25, 0.25, 0.25, 0.25)


def _servers(mode, het, rounds, buffer_k):
    """The reduced speech trial in both packages: ResNet-10, M=3, E=1,
    FedAvg, SGD lr 0.05 momentum 0.9, batch 5, FedTune on."""
    jm, tm, p0, jopt = _tiny()
    jcfg, _ = _tiny_pair()
    n = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(p0))
    kw = dict(m=3, e=1.0, batch_size=5, target_accuracy=0.99,
              max_rounds=rounds, eval_points=128)
    j = JFLServer(
        jm, j_make_dataset(JDataSpec(**SPEC)), j_get_aggregator("fedavg"),
        jopt, JCostModel(flops_per_example=jm.flops_per_example,
                         param_count=n),
        JFLConfig(**kw),
        tuner=JFedTune(JFedTuneConfig(preference=JPreference(*PREF)),
                       JHyperParams(3, 1.0)),
        fleet=None if het is None else j_sample_fleet(het, 24, seed=3),
        runtime_config=JRuntimeConfig(mode=mode, buffer_k=buffer_k))
    t = FLServer(
        tm, make_dataset(DataSpec(**SPEC)), get_aggregator("fedavg"),
        get_optimizer("sgd", 0.05, momentum=0.9),
        CostModel(flops_per_example=tm.flops_per_example, param_count=n),
        FLConfig(**kw),
        tuner=FedTune(FedTuneConfig(preference=Preference(*PREF)),
                      HyperParams(3, 1.0)),
        fleet=None if het is None else sample_fleet(het, 24, seed=3),
        runtime_config=RuntimeConfig(mode=mode, buffer_k=buffer_k),
        device="cpu")
    return j, t, p0


@pytest.mark.parametrize("mode,het,rounds", [("sync", None, 3),
                                             ("async", "stragglers", 6),
                                             ("buffered", "mild", 3)])
def test_speech_trial_matches_reference(mode, het, rounds):
    j, t, p0 = _servers(mode, het, rounds, buffer_k=2)
    want = j.run(jax.tree.map(jnp.asarray, p0))
    got = t.run(params_from_numpy(p0, "cpu"))
    assert got.rounds == want.rounds == rounds
    assert [(h.m, h.e) for h in got.history] == \
        [(h.m, h.e) for h in want.history]
    assert (got.final_m, got.final_e) == (want.final_m, want.final_e)
    assert got.total_cost.as_tuple() == want.total_cost.as_tuple()
    assert got.dispatch_log == want.dispatch_log
    assert got.staleness_log == want.staleness_log
    np.testing.assert_allclose([h.accuracy for h in got.history],
                               [h.accuracy for h in want.history], atol=0.01)


def test_fedtune_speech_launcher_on_cpu(capsys):
    fixed, tuned, gain = fedtune_speech.main(["--device", "cpu",
                                              "--rounds", "2"])
    out = capsys.readouterr().out
    assert "=== fixed (M=5, E=2) ===" in out and "=== FedTune ===" in out
    assert fixed.rounds == tuned.rounds == 2
    assert (fixed.final_m, fixed.final_e) == (5, 2)
    assert all(c > 0 for c in tuned.total_cost.as_tuple())
    assert gain == pytest.approx(-100.0 * tuned.total_cost
                                 .weighted_relative_to(fixed.total_cost,
                                                       Preference(*PREF)))
    assert f"fixed: {gain:+.2f}%" in out
    # ResNet-10 sized from the reduced dataset: 16x16x1, 10 classes
    assert tuned.params["stem"].shape == (3, 3, 1, 8)
    assert tuned.params["head_w"].shape == (64, 10)
