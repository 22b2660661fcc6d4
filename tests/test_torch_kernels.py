"""The port's kernel layer against the JAX reference, on the CPU.

``repro_torch.kernels.ref`` must equal ``repro.kernels.ref`` BIT FOR BIT on
the same f32 inputs: the fold order, the materialised ``w * x``, the IEEE
division and round-half-to-even are all fixed by the reference.  On a CPU
tensor the port's ``ops`` entry points run exactly these plain versions.
(The Hopper kernels themselves are held against the plain versions on the
card by ``chip_smoke.py``.)  Cases follow tests/test_kernels.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import fed_aggregate as fa_mod  # noqa: E402
from repro_torch.kernels import fed_reduce as fr_mod  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402


def _t(a):
    return torch.from_numpy(np.array(a))


def _reduce_case(m, n, t, seed, *, interleave=False, zero_w=0):
    rng = np.random.default_rng(seed)
    rows = rng.standard_normal((m, n)).astype(np.float32)
    w = rng.uniform(1.0, 100.0, m).astype(np.float32)
    if zero_w:
        w[rng.choice(m, zero_w, replace=False)] = 0.0
    seg = rng.integers(0, t, m)
    if not interleave:
        seg = np.sort(seg)
    base = rng.standard_normal((t, n)).astype(np.float32)
    return w, rows, seg.astype(np.int32), base


def _both(w, rows, seg, t, base=None, **kw):
    """(port result, JAX reference result) as numpy arrays."""
    jkw = dict(kw)
    tkw = dict(kw)
    if kw.get("quant_ref") is not None:
        jkw["quant_ref"] = jnp.asarray(kw["quant_ref"])
        tkw["quant_ref"] = _t(kw["quant_ref"])
    if kw.get("quant_enabled") is not None:
        jkw["quant_enabled"] = jnp.asarray(kw["quant_enabled"])
        tkw["quant_enabled"] = _t(kw["quant_enabled"])
    want = jops.fed_reduce(jnp.asarray(w), jnp.asarray(rows),
                           jnp.asarray(seg), t,
                           None if base is None else jnp.asarray(base),
                           **jkw)
    got = ops.fed_reduce(_t(w), _t(rows), _t(seg), t,
                         None if base is None else _t(base), **tkw)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("m,n,t", [(1, 256, 1), (7, 300, 3), (16, 1024, 4),
                                   (33, 4097, 8)])
@pytest.mark.parametrize("mode", ["plain", "normalize", "base", "quant"])
def test_fed_reduce_ref_matches_reference_bitwise(m, n, t, mode):
    """Every fusion mode, non-pow2 row counts and column tails."""
    w, rows, seg, base = _reduce_case(m, n, t, seed=m * 1000 + n)
    kw = {}
    if mode in ("normalize", "base"):
        kw["normalize"] = True
    if mode == "quant":
        kw = {"normalize": True, "leaf_sizes": (n // 3, n - n // 3),
              "quant_ref": base, "quant_enabled": np.ones(m, bool)}
    b = base if mode in ("base", "quant") else None
    got, want = _both(w, rows, seg, t, b, **kw)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("interleave", [False, True])
@pytest.mark.parametrize("quant", [False, True])
def test_fed_reduce_interleaved_segments_bitwise(interleave, quant):
    """Interleaved segments and the quant round trip match the reference,
    and lane t equals a standalone T=1 call inside the port."""
    m, n, t = 24, 513, 5
    w, rows, seg, base = _reduce_case(m, n, t, seed=42,
                                      interleave=interleave)
    kw = dict(normalize=True)
    if quant:
        kw.update(leaf_sizes=(200, n - 200), quant_ref=base,
                  quant_enabled=np.ones(m, bool))
    got, want = _both(w, rows, seg, t, base, **kw)
    np.testing.assert_array_equal(got, want)
    for s in range(t):
        idx = np.nonzero(seg == s)[0]
        if len(idx) == 0:
            np.testing.assert_array_equal(got[s], base[s])
            continue
        kw1 = dict(normalize=True)
        if quant:
            kw1.update(leaf_sizes=(200, n - 200),
                       quant_ref=_t(base[s][None]),
                       quant_enabled=torch.ones(len(idx), dtype=torch.bool))
        alone = ops.fed_reduce(_t(w[idx]), _t(rows[idx]),
                               torch.zeros(len(idx), dtype=torch.int32), 1,
                               _t(base[s][None]), **kw1)
        np.testing.assert_array_equal(got[s], alone[0].numpy())


def test_fed_reduce_singleton_and_empty_segments_bitwise():
    n = 128
    rng = np.random.default_rng(3)
    rows = rng.standard_normal((3, n)).astype(np.float32)
    base = rng.standard_normal((4, n)).astype(np.float32)
    w = np.asarray([5.0, 2.0, 3.0], np.float32)
    seg = np.asarray([0, 0, 2], np.int32)         # lanes 1 and 3 empty
    got, want = _both(w, rows, seg, 4, base, normalize=True)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[1], base[1])
    np.testing.assert_array_equal(got[3], base[3])


def test_fed_reduce_zero_weight_rows_bitwise():
    """Zero-weight rows match the reference and leave every lane as it
    was without them."""
    m, n, t = 12, 257, 3
    w, rows, seg, base = _reduce_case(m, n, t, seed=7, zero_w=3)
    got, want = _both(w, rows, seg, t, base, normalize=True)
    np.testing.assert_array_equal(got, want)
    keep = w != 0
    fewer = ops.fed_reduce(_t(w[keep]), _t(rows[keep]), _t(seg[keep]), t,
                           _t(base), normalize=True)
    np.testing.assert_array_equal(got, fewer.numpy())


def test_fed_reduce_per_row_quant_mask_bitwise():
    m, n, t = 10, 300, 2
    w, rows, seg, base = _reduce_case(m, n, t, seed=11)
    ls = (100, n - 100)
    en = np.arange(m) % 2 == 0
    got, want = _both(w, rows, seg, t, base, normalize=True, leaf_sizes=ls,
                      quant_ref=base, quant_enabled=en)
    np.testing.assert_array_equal(got, want)
    pre_t = ref._quant_rows(_t(rows), _t(seg), _t(base), _t(en), ls)
    pre_j = jax.jit(jref._quant_rows, static_argnames=("leaf_sizes",))(
        jnp.asarray(rows), jnp.asarray(seg), jnp.asarray(base),
        jnp.asarray(en), ls)
    np.testing.assert_array_equal(pre_t.numpy(), np.asarray(pre_j))
    # disabled rows pass through untouched
    np.testing.assert_array_equal(pre_t.numpy()[~en], rows[~en])


def test_fed_reduce_matches_pallas_interpret_bitwise():
    """The Pallas kernel in interpret mode is the same function."""
    w, rows, seg, base = _reduce_case(9, 700, 3, seed=5, interleave=True)
    want = jops.fed_reduce(jnp.asarray(w), jnp.asarray(rows),
                           jnp.asarray(seg), 3, jnp.asarray(base),
                           normalize=True, force_pallas=True, interpret=True)
    got = ops.fed_reduce(_t(w), _t(rows), _t(seg), 3, _t(base),
                         normalize=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("packing", ["lane_major", "interleaved"])
def test_fed_reduce_past_three_thousand_rows_bitwise(packing):
    """T = 32 lanes of 100 rows (M = 3,200, more than the 3,000 rows the
    kernel once took), normalize on: the port equals the reference's
    oracle ``repro.kernels.ref.fed_reduce_ref`` bit for bit, packed lane by
    lane (the sweep engine's packing) and interleaved."""
    t, per, n = 32, 100, 64
    m = t * per
    rng = np.random.default_rng(3200)
    seg = np.repeat(np.arange(t), per)
    if packing == "interleaved":
        seg = rng.permutation(seg)
    seg = seg.astype(np.int32)
    w = rng.uniform(1.0, 300.0, m).astype(np.float32)
    rows = rng.standard_normal((m, n)).astype(np.float32)
    want = jref.fed_reduce_ref(jnp.asarray(w), jnp.asarray(rows),
                               jnp.asarray(seg), t, normalize=True)
    got = fr_mod.fed_reduce(_t(w), _t(rows), _t(seg), t, normalize=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("m,n", [(1, 256), (1, 4099), (4, 1000), (16, 8192)])
def test_fed_aggregate_ref_matches_reference(m, n):
    """Bitwise at M=1 (the FedAsync mix).  At M>1 the reference's einsum
    leaves the summation order open, so the two agree within rtol=1e-6 of
    the sum's magnitude ``sum_m |w_m d_m| + |base|`` (a plain rtol on the
    result fails where the terms cancel)."""
    rng = np.random.default_rng(m * 7 + n)
    w = rng.uniform(0.0, 1.0, m).astype(np.float32)
    d = rng.standard_normal((m, n)).astype(np.float32)
    base = rng.standard_normal(n).astype(np.float32)
    want = np.asarray(jref.fed_aggregate_ref(jnp.asarray(w), jnp.asarray(d),
                                             jnp.asarray(base)))
    got = ops.fed_aggregate(_t(w), _t(d), _t(base)).numpy()
    if m == 1:
        np.testing.assert_array_equal(got, want)
    else:
        mag = np.abs(w[:, None] * d).sum(0) + np.abs(base)
        assert np.all(np.abs(got - want) <= 1e-6 * mag)


def test_cpu_tensors_take_the_plain_version():
    """On the CPU the wrappers run the plain version: no build, no
    launch counted."""
    before = (fr_mod.launches, fa_mod.launches)
    w, rows, seg, base = _reduce_case(4, 64, 2, seed=1)
    out = fr_mod.fed_reduce(_t(w), _t(rows), _t(seg), 2, _t(base))
    want = ref.fed_reduce_ref(_t(w), _t(rows), _t(seg), 2, _t(base))
    assert torch.equal(out, want)
    agg = fa_mod.fed_aggregate(_t(w), _t(rows), _t(base[0]))
    assert torch.equal(agg, ref.fed_aggregate_ref(_t(w), _t(rows),
                                                  _t(base[0])))
    assert (fr_mod.launches, fa_mod.launches) == before


def test_kernel_path_rejects_non_cuda_tensors():
    """The launch path never falls back: a tensor that is not on CUDA is
    refused."""
    w, rows, seg, _ = _reduce_case(2, 8, 1, seed=2)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fr_mod._launch(_t(w), _t(rows), _t(seg), 1, None, False)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fa_mod._launch(_t(w), _t(rows), None)


# ---------------------------------------------------------------------------
# flash_attention and rglru_scan (the LM zoo's kernels): the plain versions
# against the reference's oracles and its Pallas kernels in interpret mode.
# Cases follow tests/test_kernels.py.  Tolerances are the reference's own:
# 2e-5 for attention (f32, summed in another order), 1e-5 for the scan
# (the model's associative scan rounds in another order).
# ---------------------------------------------------------------------------

from repro.kernels.flash_attention import flash_attention as jflash  # noqa: E402
from repro.kernels.rglru_scan import rglru_scan as jscan  # noqa: E402
from repro.models import recurrent as jrec  # noqa: E402
from repro_torch.kernels import flash_attention as fl_mod  # noqa: E402
from repro_torch.kernels import rglru_scan as sc_mod  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402

# the model's associative scan, jitted (eager, it takes seconds a call)
_jassoc_scan = jax.jit(jrec.rglru_scan)


def _qkv(b, h, kh, s, t, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, s, d)).astype(np.float32),
            rng.standard_normal((b, kh, t, d)).astype(np.float32),
            rng.standard_normal((b, kh, t, d)).astype(np.float32))


@pytest.mark.parametrize("b,h,kh,s,d", [
    (1, 2, 1, 128, 32), (2, 4, 2, 256, 64), (1, 4, 4, 256, 128),
])
@pytest.mark.parametrize("window,cap", [
    (None, None), (64, None), (None, 50.0), (96, 30.0),
])
def test_flash_attention_ref_matches_reference(b, h, kh, s, d, window, cap):
    q, k, v = _qkv(b, h, kh, s, s, d, seed=s + d)
    want = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), window=window, cap=cap)
    got = ops.flash_attention(_t(q), _t(k), _t(v), window=window, cap=cap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("s,t,causal,window", [
    (100, 128, True, None), (1, 77, True, 16), (60, 60, False, 8),
    (50, 90, False, None),
])
def test_flash_attention_ref_alignment_matches_reference(s, t, causal,
                                                         window):
    """Ragged and unaligned lengths: query i sits at key i + (T - S)."""
    q, k, v = _qkv(2, 4, 1, s, t, 32, seed=s * t)
    want = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=causal,
                                    window=window)
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                              window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("window,cap", [(96, 30.0), (64, None)])
def test_flash_attention_ref_matches_pallas_interpret(window, cap):
    q, k, v = _qkv(1, 4, 2, 128, 128, 32, seed=3)
    want = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  window=window, cap=cap, block_q=64, block_k=64,
                  interpret=True)
    got = ops.flash_attention(_t(q), _t(k), _t(v), window=window, cap=cap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("window,cap", [(None, None), (5, 20.0)])
def test_flash_core_layout_equals_naive_attention(window, cap):
    """The model hands the kernel its (B,S,K,G,D) and (B,S,K,D) tensors as
    strided (B,H,S,D) views and gets (B,S,H,D) back; on CPU tensors the
    same plumbing runs the plain version and must equal the naive path."""
    rng = np.random.default_rng(9)
    q = _t(rng.standard_normal((2, 19, 2, 3, 32)).astype(np.float32))
    k = _t(rng.standard_normal((2, 19, 2, 32)).astype(np.float32))
    v = _t(rng.standard_normal((2, 19, 2, 32)).astype(np.float32))
    pos = torch.arange(19)
    got = tattn.flash_core(q, k, v, window=window, cap=cap)
    want = tattn.naive_attention(q, k, v, q_pos=pos, k_pos=pos,
                                 window=window, cap=cap)
    assert got.shape == (2, 19, 6, 32)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("b,t,w", [(1, 128, 128), (2, 256, 128),
                                   (4, 128, 512), (3, 192, 384)])
def test_rglru_scan_ref_matches_reference(b, t, w):
    rng = np.random.default_rng(b * t + w)
    a = rng.uniform(0.5, 0.999, (b, t, w)).astype(np.float32)
    x = (rng.standard_normal((b, t, w)) * 0.1).astype(np.float32)
    got = ops.rglru_scan(_t(a), _t(x)).numpy()
    for want in (jref.rglru_scan_ref(jnp.asarray(a), jnp.asarray(x)),
                 jscan(jnp.asarray(a), jnp.asarray(x), block_b=1,
                       block_w=128, chunk_t=64, interpret=True),
                 _jassoc_scan(jnp.asarray(a), jnp.asarray(x))):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


def test_rglru_scan_ref_rounds_the_product_first():
    """The plain version is the loop ``h = a*h + b`` with ``a*h`` rounded
    to f32 before the add, which the kernel's __fmul_rn/__fadd_rn repeat
    bit for bit; numpy's f32 loop is the same arithmetic."""
    rng = np.random.default_rng(4)
    a = rng.uniform(0.0, 1.0, (2, 50, 33)).astype(np.float32)
    x = rng.standard_normal((2, 50, 33)).astype(np.float32)
    h = np.zeros((2, 33), np.float32)
    want = np.empty_like(a)
    for i in range(50):
        h = (a[:, i] * h).astype(np.float32) + x[:, i]
        want[:, i] = h
    np.testing.assert_array_equal(ops.rglru_scan(_t(a), _t(x)).numpy(), want)


def test_lm_kernel_wrappers_take_the_plain_version_on_cpu():
    before = (fl_mod.launches, sc_mod.launches)
    q, k, v = _qkv(1, 2, 1, 16, 16, 32, seed=1)
    assert torch.equal(fl_mod.flash_attention(_t(q), _t(k), _t(v), window=4),
                       ref.flash_attention_ref(_t(q), _t(k), _t(v), window=4))
    a = _t(np.full((1, 8, 4), 0.5, np.float32))
    assert torch.equal(sc_mod.rglru_scan(a, a), ref.rglru_scan_ref(a, a))
    assert (fl_mod.launches, sc_mod.launches) == before


def test_lm_kernel_paths_reject_non_cuda_tensors():
    q, k, v = _qkv(1, 2, 1, 16, 16, 32, seed=1)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fl_mod._launch(_t(q), _t(k), _t(v), True, None, None)
    a = _t(np.ones((1, 4, 4), np.float32))
    with pytest.raises(ValueError, match="CUDA tensor"):
        sc_mod._launch(a, a)


# ---------------------------------------------------------------------------
# The CUDA flash_attention's 3xTF32 arithmetic, emulated on the CPU: every
# operand x of both products is split into hi = tf32_rna(x) and
# lo = tf32_rna(x - hi), and a.b ~= a_hi.b_hi + (a_hi.b_lo + a_lo.b_hi).
# A TF32 product is exact in f32 (11 x 11 significand bits), so f32 matmuls
# of TF32 values repeat the tensor cores' products; their sums in f32 stand
# for the cores' f32 accumulate.  Three passes hold the reference's 2e-5;
# one pass of TF32 does not, which is why the kernel spends three.
# ---------------------------------------------------------------------------

def _tf32_rna(x):
    """``cvt.rna.tf32.f32`` on the f32 bit pattern: keep 10 mantissa bits,
    rounding half away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(x):
    hi = _tf32_rna(x)
    return hi, _tf32_rna(x - hi)


def _tf32_matmul(a, b, passes):
    a_hi, a_lo = _split(a)
    b_hi, b_lo = _split(b)
    if passes == 1:
        return a_hi @ b_hi
    return (a_hi @ b_lo + a_lo @ b_hi) + a_hi @ b_hi


def _tf32_attention(q, k, v, window, passes):
    """Causal sliding-window attention, q (B,H,S,D), k/v (B,Kh,T,D), with
    both products in emulated TF32 (one or three passes)."""
    g = q.shape[1] // k.shape[1]
    kk = k.repeat_interleave(g, 1)
    vv = v.repeat_interleave(g, 1)
    s_len, t_len = q.shape[2], k.shape[2]
    scores = _tf32_matmul(q, kk.transpose(-1, -2), passes) * q.shape[-1] ** -0.5
    q_pos = torch.arange(s_len)[:, None] + (t_len - s_len)
    k_pos = torch.arange(t_len)[None, :]
    mask = (k_pos <= q_pos) & (k_pos > q_pos - window)
    scores = torch.where(mask, scores, torch.full_like(scores, ref.NEG_INF))
    return _tf32_matmul(torch.softmax(scores, -1), vv, passes)


@pytest.mark.parametrize("passes,holds", [(3, True), (1, False)])
def test_flash_attention_tf32_split_products_against_reference(passes, holds):
    """D=256, S=T=512, window 128, MQA with 16 heads (recurrentgemma's
    local layer, cut in length): 3xTF32 is within rtol = atol = 2e-5 of
    the JAX oracle; one TF32 pass is not."""
    q, k, v = _qkv(1, 16, 1, 512, 512, 256, seed=13)
    want = np.asarray(jref.flash_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=128))
    got = _tf32_attention(_t(q), _t(k), _t(v), 128, passes).numpy()
    close = np.allclose(got, want, rtol=2e-5, atol=2e-5)
    assert close == holds, float(np.abs(got - want).max())
    if not holds:
        assert np.abs(got - want).max() > 1e-4


def test_tf32_rna_rounds_half_away_from_zero():
    """The emulated cvt.rna: 1 + 2^-11 (a tie) rounds up to 1 + 2^-10, and
    its negation down; 1 + 2^-12 rounds to 1; a TF32 value is unchanged."""
    x = torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 2.0 ** -12,
                      1 + 2.0 ** -10, 3.0], dtype=torch.float32)
    want = torch.tensor([1 + 2.0 ** -10, -(1 + 2.0 ** -10), 1.0,
                         1 + 2.0 ** -10, 3.0], dtype=torch.float32)
    assert torch.equal(_tf32_rna(x), want)
    hi, lo = _split(x)
    assert torch.equal(hi + lo, x)
