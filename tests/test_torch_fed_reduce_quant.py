"""The int8 upload round trip of ``fed_reduce`` (``quant_ref``): the port's
plain version against the reference's jitted one, bit for bit, and the
Hopper wrapper's host side on the CPU.

The card's kernel (``csrc/fed_reduce.cu::fed_reduce_quant_f32``) is held
against this plain version by ``chip_smoke.py`` and ``tests/test_torch_gpu.py``;
here the plain ``_quant_rows`` and ``fed_reduce_ref`` meet the reference's
``jax.jit``-compiled ones (XLA rewrites ``/ 127`` into a multiply by its
f32 reciprocal and contracts ``g + q * scale`` into an FMA: departure 1)
on the leaf splits the main path gives them, on leaves as narrow as one
column and on values at exact half-steps of the scale (ties to even) and
at +-127.  The kernel's quotient (a staged reciprocal where it provably
rounds as the IEEE division) is held to the division in emulated float32.
"""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.paper_models import MLPConfig as JMLPConfig  # noqa: E402
from repro.configs.paper_models import RESNET10 as J_RESNET10  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro_torch.configs.paper_models import MLPConfig, RESNET10  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import fed_reduce as fr_mod  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

RECIP_127 = np.float32(1.0) / np.float32(127.0)

_j_quant_rows = jax.jit(jref._quant_rows, static_argnames=("leaf_sizes",))
_j_fed_reduce = jax.jit(jref.fed_reduce_ref, static_argnames=(
    "num_segments", "normalize", "leaf_sizes"))


def _ref_leaf_sizes(model_cfg):
    """A reference model's leaf widths in ``jax.tree.flatten`` order."""
    params = j_build_model(model_cfg).init(jax.random.PRNGKey(0))
    return tuple(int(p.size) for p in jax.tree.leaves(params))


def _port_leaf_sizes(model_cfg):
    return tuple(p.numel() for p in leaves(build_model(model_cfg).init(0,
                                                                       "cpu")))


def _rows(rng, m, sizes, g, seg):
    """Rows near their segment's reference, each leaf at its own scale."""
    scales = np.concatenate([np.full(s, 10.0 ** rng.uniform(-4, -1))
                             for s in sizes]).astype(np.float32)
    noise = rng.standard_normal((m, sum(sizes))).astype(np.float32)
    return (g[seg] + noise * scales).astype(np.float32)


def _half_steps():
    """One row of a 400-wide leaf against a zero reference: its max |d| is
    127 * 2^-7, so the scale is that times RECIP_127 in f32, and the rest
    are d = +-(k + 1/2) * scale wherever that division is exact in f32
    (ties, to even), +-127 * scale and -max (the clamp's edges)."""
    amax = np.float32(127.0 * 2.0 ** -7)
    s = np.float32(amax * RECIP_127)
    ties = []
    for k in range(127):
        d = np.float32((k + 0.5) * np.float64(s))
        if np.float32(d / s) == np.float32(k + 0.5):
            ties += [d, -d]
    assert len(ties) >= 100, len(ties)
    row = np.zeros(400, np.float32)
    vals = [amax, -amax, np.float32(127.0) * s, -np.float32(127.0) * s] + ties
    row[:len(vals)] = vals
    return row[None, :], np.zeros((1, 400), np.float32), (400,)


def _case(name):
    """(rows, segments, quant_ref, quant_enabled, leaf_sizes, T)."""
    rng = np.random.default_rng(CASES.index(name))
    if name == "half_steps":
        rows, g, sizes = _half_steps()
        return rows, np.zeros(1, np.int32), g, None, sizes, 1
    if name == "emnist_mlp":
        cfg = (JMLPConfig(name="m", in_dim=784, hidden=(48,), n_classes=62),
               MLPConfig(name="m", in_dim=784, hidden=(48,), n_classes=62))
    elif name == "speech_mlp":
        cfg = (JMLPConfig(name="m", in_dim=1024, hidden=(48,), n_classes=35),
               MLPConfig(name="m", in_dim=1024, hidden=(48,), n_classes=35))
    elif name == "resnet10":
        cfg = (J_RESNET10, RESNET10)
    if name in ("emnist_mlp", "speech_mlp", "resnet10"):
        sizes = _ref_leaf_sizes(cfg[0])
        assert _port_leaf_sizes(cfg[1]) == sizes
        m, t = 3, 1
        seg = np.zeros(m, np.int32)
        g = rng.standard_normal((t, sum(sizes))).astype(np.float32) * 0.05
        return _rows(rng, m, sizes, g, seg), seg, g, None, sizes, t
    if name == "narrow_leaves":
        sizes = (1, 3, 35, 1, 62, 3, 200)
        m, t = 5, 1
        seg = np.zeros(m, np.int32)
        g = rng.standard_normal((t, sum(sizes))).astype(np.float32)
        return (_rows(rng, m, sizes, g, seg), seg, g, np.array(
            [1, 0, 1, 1, 0], bool), sizes, t)
    if name == "zero_leaf":
        sizes = (35, 62, 9000)
        m, t = 4, 1
        seg = np.zeros(m, np.int32)
        g = rng.standard_normal((t, sum(sizes))).astype(np.float32)
        rows = _rows(rng, m, sizes, g, seg)
        rows[:, 35:97] = g[0, 35:97]          # leaf 1: d == 0, scale 1e-12
        return rows, seg, g, None, sizes, t
    if name == "interleaved_t4":
        sizes = (1, 35, 62, 8300)
        m, t = 12, 4
        seg = rng.integers(0, t, m).astype(np.int32)
        g = rng.standard_normal((t, sum(sizes))).astype(np.float32)
        g[3] = 0.0                            # a padded lane's zero reference
        en = rng.integers(0, 2, m).astype(bool)
        return _rows(rng, m, sizes, g, seg), seg, g, en, sizes, t
    raise KeyError(name)


CASES = ["emnist_mlp", "speech_mlp", "resnet10", "narrow_leaves",
         "zero_leaf", "interleaved_t4", "half_steps"]


@pytest.mark.parametrize("name", CASES)
def test_quant_round_trip_is_the_references_bit_for_bit(name):
    rows, seg, g, en, sizes, t = _case(name)
    m, n = rows.shape
    assert sum(sizes) == n
    ten = None if en is None else torch.from_numpy(en)
    jen = None if en is None else jnp.asarray(en)
    got = ref._quant_rows(torch.from_numpy(rows), torch.from_numpy(seg),
                          torch.from_numpy(g), ten, sizes)
    want = np.asarray(_j_quant_rows(jnp.asarray(rows), jnp.asarray(seg),
                                    jnp.asarray(g), jen, sizes))
    np.testing.assert_array_equal(got.numpy(), want)
    if en is not None:                        # disabled rows pass through
        np.testing.assert_array_equal(got.numpy()[~en], rows[~en])
    if name == "zero_leaf":
        np.testing.assert_array_equal(got.numpy()[:, 35:97], g[0, 35:97][None]
                                      .repeat(m, 0))
    if name == "half_steps":                  # the clamp's edges and the ties
        s = np.float32(rows[0, 0] * RECIP_127)
        q = np.rint(rows[0] / s)
        assert q.max() == 127 and q.min() == -127
        np.testing.assert_array_equal(got.numpy()[0],
                                      np.float32(q) * s)
    # the whole call: the round trip, then the normalised fold
    rng = np.random.default_rng(m * n)
    w = rng.uniform(1.0, 300.0, m).astype(np.float32)
    got = ref.fed_reduce_ref(torch.from_numpy(w), torch.from_numpy(rows),
                             torch.from_numpy(seg), t, normalize=True,
                             leaf_sizes=sizes, quant_ref=torch.from_numpy(g),
                             quant_enabled=ten)
    want = np.asarray(_j_fed_reduce(
        jnp.asarray(w), jnp.asarray(rows), jnp.asarray(seg), t,
        normalize=True, leaf_sizes=sizes, quant_ref=jnp.asarray(g),
        quant_enabled=jen))
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# the wrapper's host side: what it checks and caches before any launch
# ---------------------------------------------------------------------------

def test_leaf_offsets_are_cached_per_split_and_device():
    sizes = (48, 37632, 62, 2976)
    cpu = torch.device("cpu")
    off = fr_mod.leaf_offsets(sizes, cpu)
    assert off.dtype == torch.int32 and off.device == cpu
    assert off.tolist() == [0, 48, 37680, 37742, 40718]
    assert fr_mod.leaf_offsets(sizes, cpu) is off
    assert fr_mod.leaf_offsets(sizes, torch.device("meta")) is not off
    assert fr_mod.leaf_offsets((1, 35), cpu).tolist() == [0, 1, 36]


@pytest.fixture
def no_launch(monkeypatch):
    """Fails the test if anything reaches the kernel library."""
    def refuse(*a, **kw):
        raise AssertionError("the kernel library was reached")
    monkeypatch.setattr(build, "library", refuse)


def _meta_call(m=4, n=100, t=2, **kw):
    """``fed_reduce`` on tensors that are not on the CPU (``meta``), so
    the wrapper takes its kernel route: its checks run, the library must
    not be reached."""
    meta = torch.device("meta")
    args = dict(leaf_sizes=(30, 70),
                quant_ref=torch.empty((t, n), device=meta),
                quant_enabled=torch.ones(m, dtype=torch.bool, device=meta))
    args.update(kw)
    return fr_mod.fed_reduce(torch.empty(m, device=meta),
                             torch.empty((m, n), device=meta),
                             torch.zeros(m, dtype=torch.int32, device=meta),
                             t, normalize=True, **args)


@pytest.mark.parametrize("kw,match", [
    (dict(leaf_sizes=None), "needs leaf_sizes"),
    (dict(leaf_sizes=(30, 60)), "sum to N=100"),
    (dict(leaf_sizes=(0, 100)), "positive"),
    (dict(quant_ref=torch.empty((1, 100), device="meta")), r"\(2, 100\)"),
    (dict(quant_ref=torch.empty((2, 100), dtype=torch.float64,
                                device="meta")), "float32"),
    (dict(quant_ref=torch.empty((2, 100))), "on meta"),
    (dict(quant_enabled=torch.ones(3, dtype=torch.bool, device="meta")),
     r"\(4,\) bool"),
    (dict(quant_enabled=torch.ones(4, dtype=torch.int32, device="meta")),
     r"\(4,\) bool"),
])
def test_wrapper_refuses_bad_round_trip_inputs_before_any_launch(
        kw, match, no_launch):
    with pytest.raises(ValueError, match=match):
        _meta_call(**kw)


def test_wrapper_checks_pass_then_the_launch_needs_a_card(no_launch):
    """Valid inputs get through every check (mask None or (M,) bool) and
    stop at the device check, before the library: no fallback to the plain
    pre-pass, which is never called on this route."""
    calls = []
    inner = ref._quant_rows
    ref._quant_rows = lambda *a, **k: calls.append(a) or inner(*a, **k)
    try:
        for en in (None, torch.ones(4, dtype=torch.bool, device="meta")):
            with pytest.raises(ValueError, match="needs a CUDA tensor"):
                _meta_call(quant_enabled=en)
    finally:
        ref._quant_rows = inner
    assert calls == []


# ---------------------------------------------------------------------------
# the kernel's quotient: d * (1/scale) where it rounds as d / scale
# ---------------------------------------------------------------------------

def _kernel_tie_margin():
    """``kTieMargin`` as ``csrc/fed_reduce.cu`` defines it (1.0f / k)."""
    text = (build.CSRC / "fed_reduce.cu").read_text()
    k = re.search(r"kTieMargin = 1\.0f / (\d+)\.0f;", text)
    assert k is not None, "kTieMargin not found in fed_reduce.cu"
    return np.float32(1.0) / np.float32(k.group(1))


def test_reciprocal_quotient_rounds_as_the_ieee_division():
    """The fold's round trip (``csrc/fed_reduce.cu::round_trip``) takes q =
    rint(d * RN(1/scale)) where that product lies farther than kTieMargin
    from every half-integer (|quot - rint(quot)| < 0.5 - kTieMargin), and
    rint(RN(d / scale)) elsewhere.  In float32
    arithmetic emulated with numpy (each operation rounded to nearest
    even), that q is the IEEE quotient's on leaves of every magnitude (the
    1e-12 floor included), on exact ties and one ulp beside them; the
    product stays within a thirty-second of the margin of the IEEE
    quotient, and on random values the division is the exception."""
    rng = np.random.default_rng(27)
    margin = _kernel_tie_margin()
    amax = (10.0 ** rng.uniform(-13, 4, 4000)).astype(np.float32)
    amax[:6] = [127.0 / 128.0, 1e-12, 1.27e-10, 1e-30, 127.0, 65504.0]
    scale = np.maximum(amax * RECIP_127, np.float32(1e-12))
    d = (rng.uniform(-1.0, 1.0, (amax.size, 256)) * amax[:, None]).astype(
        np.float32)
    d[:, 0], d[:, 1] = amax, -amax
    halves = (rng.integers(-127, 127, (amax.size, 32)) + 0.5).astype(
        np.float32)
    d[:, 2:34] = halves * scale[:, None]           # ties where exact
    d[:, 34:66] = np.nextafter(d[:, 2:34], np.float32(np.inf))
    d[:, 66:98] = np.nextafter(d[:, 2:34], np.float32(-np.inf))
    d = np.clip(d, -amax[:, None], amax[:, None])  # |d| <= the leaf's max
    assert d.dtype == scale.dtype == np.float32

    ieee = d / scale[:, None]
    quot = d * (np.float32(1.0) / scale)[:, None]
    far = np.abs(quot - np.rint(quot)) < np.float32(0.5) - margin
    q = np.where(far, np.rint(quot), np.rint(ieee))
    assert np.array_equal(q, np.rint(ieee))
    assert np.abs(quot - ieee).max() <= margin / 32
    ties = ieee - np.floor(ieee) == np.float32(0.5)
    assert ties.sum() >= 32 and not far[ties].any()
    assert far[:, 98:].mean() > 0.99               # on the random columns


def test_profile_quant_stamps_every_phase_edge_of_the_kernel():
    """``launch/profile_quant`` instruments ``fed_reduce.cu`` at each of the
    round trip kernel's phase edges (on every path a block takes: a grid
    barrier in its first absmax unit or after the phase, in its first fold
    item or after the loop), and refuses a source whose anchors moved."""
    from repro_torch.launch import profile_quant as pq

    text = (build.CSRC / "fed_reduce.cu").read_text()
    out = pq.instrumented_source(text)
    counts = [out.count(f"EDGE({i})") for i in range(len(pq.EDGES))]
    assert counts == [1, 2, 2, 1, 2, 2, 1]
    assert "quant_timeline_read" in out and "quant_timeline_reset" in out
    with pytest.raises(ValueError, match="anchor"):
        pq.instrumented_source(text.replace("grid_sync();", "grid_sync( );"))
