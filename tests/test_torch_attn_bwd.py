"""The CUDA flash_attention_bwd's accumulation scheme, emulated on the CPU.

``csrc/flash_attention_bwd.cu`` runs every product as ``wgmma`` on split
TF32 operands, a b ~= a_hi b_hi + a_hi b_lo + a_lo b_hi, with A_hi . [B_hi;
B_lo] and A_lo . B_hi in separate accumulators.  The tensor cores' f32
accumulation truncates (rounds toward zero), so the kernel keeps each
tensor-core sum short and adds it to a running sum on the f32 pipes, which
round to nearest.  The flush period is one step: dV^T and dK^T over one
64-row step, dQ over one 32-key step, S and dP over one 64-wide head-dim
chunk.

Here each k-step of 8 (one ``wgmma``) is emulated exactly, with the
kernel's splits (B planes rounded, A fragments cut to TF32 as they are
loaded): the 8 products of TF32 values are exact in f64, their sum is
added to the accumulator and the result rounded toward zero to f32; at
every flush the three accumulators are added in f32 as the kernel adds
them.  One kv-major block
(32 keys, every row of the walk live) is held against the plain version
``ref.flash_attention_bwd_ref`` within 1e-4 of each gradient's max-abs, on
walks as long as gemma2-2b's (8,192 rows: 4,096 positions x 2 heads) and
recurrentgemma-9b's (33,280 rows: 2,080 positions x 16 heads) at a
narrower head dim.  Summing the whole walk in the tensor cores stays
within the bound at gemma2's length but misses it at recurrentgemma's:
that is what pins the period.

The bf16 backward (``csrc/flash_attention_bwd_bf16.cu``) multiplies bf16
operands, whose products are exact in f32, in k-steps of 16, and keeps its
gradient sums in the tensor cores over the whole walk: its flush period is
the walk.  Its card limit is 2e-2 of each row's max-abs (P and dS are
rounded once to bf16), so one kv-major block (64 keys, each warpgroup's
S and dP over its own 32) is emulated at recurrentgemma-9b's walk, 33,280
rows, and held against the plain version row by row; the truncation alone
moves each gradient by a small fraction of that limit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

from repro_torch.kernels import ref  # noqa: E402

STEP_ROWS = 64       # the kv-major step: dV^T, dK^T flush period
KEY_TILE = 32        # the q-major step: dQ's flush period
HEAD_CHUNK = 64      # S and dP flush period


def _tf32_rna(x):
    """``cvt.rna.tf32.f32`` on the f32 bit pattern (the kernel's tf32_rna)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(x):
    """The prep pass's and the block's planes: both halves rounded."""
    hi = _tf32_rna(x)
    return hi, _tf32_rna(x - hi)


def _tf32_cut(x):
    bits = x.contiguous().view(torch.int32)
    return (bits & ~0x1FFF).view(torch.float32)


def _split_cut(x):
    """The A fragments' split, made as they are loaded: both halves cut."""
    hi = _tf32_cut(x)
    return hi, _tf32_cut(x - hi)


def _round_toward_zero(x64):
    """f64 -> f32, rounded toward zero."""
    y = x64.to(torch.float32)
    over = y.to(torch.float64).abs() > x64.abs()
    return torch.where(over, torch.nextafter(y, torch.zeros_like(y)), y)


def _tensor_core_product(a, b, period, a_cut=True):
    """a (M, K) @ b (K, N) in 3xTF32 as the kernel runs it: the tensor cores
    sum ``period`` of K into fresh accumulators (truncating at every k-step
    of 8), and each period's hi.hi + (hi.lo + lo.hi) is added in f32.  A is
    split as the kernel splits its register fragments (cut) unless it comes
    from split planes (``a_cut=False``: K^T in the dQ product)."""
    a_hi, a_lo = (_split_cut if a_cut else _split)(a)
    b_hi, b_lo = _split(b)
    pairs = ((a_hi, b_hi), (a_hi, b_lo), (a_lo, b_hi))
    run = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32)
    acc = [torch.zeros_like(run) for _ in pairs]
    for k0 in range(0, a.shape[1], 8):
        if k0 and k0 % period == 0:
            run = run + (acc[0] + (acc[1] + acc[2]))
        if k0 % period == 0:
            acc = [torch.zeros_like(run) for _ in pairs]
        ks = slice(k0, k0 + 8)
        acc = [_round_toward_zero(c.double() + x[:, ks].double()
                                  @ y[ks].double())
               for c, (x, y) in zip(acc, pairs)]
    return run + (acc[0] + (acc[1] + acc[2]))


def _emulated_bwd(q, k, v, out, lse, dout, walk_period):
    """One key tile (T = 32), non-causal, no cap: the kernel's kv-major and
    q-major arithmetic over rows f = position * G + head."""
    _, h, s, d = q.shape
    scale = d ** -0.5

    def rows(x):
        return x[0].permute(1, 0, 2).reshape(s * h, d)

    q_r, do_r, o_r = rows(q), rows(dout), rows(out)
    lse_r = lse[0].permute(1, 0).reshape(s * h)
    k_t, v_t = k[0, 0], v[0, 0]
    sc = _tensor_core_product(q_r, k_t.T, HEAD_CHUNK)
    dp = _tensor_core_product(do_r, v_t.T, HEAD_CHUNK)
    log2e = 1.4426950408889634
    p = torch.exp2(sc * (scale * log2e) - lse_r[:, None] * log2e)
    delta = (do_r * o_r).sum(-1)
    ds = p * (dp - delta[:, None]) * scale
    dv = _tensor_core_product(do_r.T, p, walk_period).T
    dk = _tensor_core_product(q_r.T, ds, walk_period).T
    dq = _tensor_core_product(k_t.T, ds.T, KEY_TILE, a_cut=False).T
    dq = dq.reshape(s, h, d).permute(1, 0, 2)[None]
    return dq, dk[None, None], dv[None, None]


@pytest.mark.parametrize("heads,positions,period,holds", [
    (2, 4096, STEP_ROWS, True),       # gemma2-2b's walk, the kernel's period
    (16, 2080, STEP_ROWS, True),      # recurrentgemma-9b's walk (window 2048)
    (2, 4096, None, True),            # whole walk in the tensor cores: holds
    (16, 2080, None, False),          # ... and misses at recurrentgemma's
])
def test_flash_attention_bwd_flush_period_against_plain(heads, positions,
                                                        period, holds):
    rng = np.random.default_rng(heads * positions)
    d = 32

    def normal(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    q, dout = normal(1, heads, positions, d), normal(1, heads, positions, d)
    k, v = normal(1, 1, KEY_TILE, d), normal(1, 1, KEY_TILE, d)
    out, lse = ref.flash_attention_ref(q, k, v, causal=False,
                                       return_lse=True)
    want = ref.flash_attention_bwd_ref(q, k, v, out, lse, dout, causal=False)
    walk = heads * positions
    got = _emulated_bwd(q, k, v, out, lse, dout, period or walk)
    rel = [float((g - w).abs().max() / w.abs().max())
           for g, w in zip(got, want)]
    if holds:
        assert max(rel) <= 1e-4, rel
    else:
        assert max(rel[1:]) > 1e-4, rel      # dK and dV drift; dQ does not
        assert rel[0] <= 1e-4, rel


BF16_KSTEP = 16      # a bf16 wgmma's k-step
BF16_KEYS = 64       # a kv-major block's keys (32 a warpgroup)


def _tc_bf16(a, b, period):
    """a (M, K) @ b (K, N), both holding bf16 values, as the bf16 tensor
    cores sum them: each k-step of 16 exact (in f64), added to the
    accumulator and rounded toward zero to f32; the accumulator starts
    afresh every ``period`` of K and those partial sums are added in f32."""
    run = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32)
    acc = torch.zeros_like(run)
    for k0 in range(0, a.shape[1], BF16_KSTEP):
        if k0 and k0 % period == 0:
            run, acc = run + acc, torch.zeros_like(run)
        ks = slice(k0, k0 + BF16_KSTEP)
        acc = _round_toward_zero(acc.double()
                                 + a[:, ks].double() @ b[ks].double())
    return run + acc


def _emulated_bwd_bf16(q, k, v, out, lse, dout, walk_period):
    """One 64-key tile, non-causal, no cap, bf16 inputs: the bf16 kernel's
    kv-major and q-major arithmetic over rows f = position * G + head.  S
    and dP per warpgroup over the head dim (one chain); P = exp2(S scale
    log2 e - lse log2 e) and dS = P (dP - delta) in f32, each rounded once
    to bf16; dV = P^T dO and dK = dS^T Q summed over the walk in the tensor
    cores (``walk_period``); dQ = dS K over each warpgroup's 32 keys, the
    two halves added in f32; the gradients in f32, before the kernel's
    one rounding to bf16 at the store."""
    _, h, s, d = q.shape
    scale = d ** -0.5
    log2e = 1.4426950408889634
    f32, bf = torch.float32, torch.bfloat16

    def rows(x):
        return x[0].permute(1, 0, 2).reshape(s * h, d).to(f32)

    q_r, do_r, o_r = rows(q), rows(dout), rows(out)
    lse2 = lse[0].permute(1, 0).reshape(s * h) * log2e
    k_t, v_t = k[0, 0].to(f32), v[0, 0].to(f32)
    halves = (slice(0, 32), slice(32, 64))
    sc = torch.cat([_tc_bf16(q_r, k_t[hk].T, d) for hk in halves], 1)
    dp = torch.cat([_tc_bf16(do_r, v_t[hk].T, d) for hk in halves], 1)
    p = torch.exp2(sc * (scale * log2e) - lse2[:, None])
    delta = (do_r * o_r).sum(-1)
    ds = p * (dp - delta[:, None])
    p_b, ds_b = p.to(bf).to(f32), ds.to(bf).to(f32)
    dv = _tc_bf16(p_b.T, do_r, walk_period)
    dk = _tc_bf16(ds_b.T, q_r, walk_period) * scale
    dq = sum(_tc_bf16(ds_b[:, hk], k_t[hk], 32) for hk in halves) * scale
    dq = dq.reshape(s, h, d).permute(1, 0, 2)[None]
    return dq, dk[None, None], dv[None, None]


def test_flash_attention_bwd_bf16_whole_walk_sums_against_plain():
    """recurrentgemma-9b's kv-major walk (16 heads x 2,080 positions =
    33,280 rows, 2,080 k-steps in the tensor cores): the bf16 kernel's
    arithmetic, gradient sums never flushed, within 2e-2 of each row's
    max-abs of the plain version (the card's limit); the truncation alone,
    against the same bf16 terms summed exactly, under 1e-3 of each
    gradient's max-abs."""
    from repro_torch.kernels import parity

    heads, positions, d = 16, 2080, 32
    rng = np.random.default_rng(23)

    def normal(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(torch.bfloat16)

    q, dout = normal(1, heads, positions, d), normal(1, heads, positions, d)
    k, v = normal(1, 1, BF16_KEYS, d), normal(1, 1, BF16_KEYS, d)
    out, lse = ref.flash_attention_ref(q, k, v, causal=False,
                                       return_lse=True)
    want = ref.flash_attention_bwd_ref(q, k, v, out, lse, dout, causal=False)
    walk = heads * positions
    got = _emulated_bwd_bf16(q, k, v, out, lse, dout, walk)
    exact = _emulated_bwd_bf16(q, k, v, out, lse, dout, BF16_KSTEP)
    rows = [parity.row_rel_err(g.to(torch.bfloat16), w)
            for g, w in zip(got, want)]
    assert max(rows) <= 2e-2, rows
    drift = [parity.rel_err(g, e) for g, e in zip(got, exact)]
    assert max(drift) <= 1e-3, drift


def test_round_toward_zero_truncates_both_signs():
    """The emulated tensor-core add: 1 + 2^-30 (not an f32) rounds down to
    1 and its negation up to -1, where round-to-nearest would agree; 1 -
    2^-30 goes to the f32 below 1."""
    x = torch.tensor([1 + 2.0 ** -30, -(1 + 2.0 ** -30), 1 - 2.0 ** -30, 3.0],
                     dtype=torch.float64)
    want = torch.tensor([1.0, -1.0, 1 - 2.0 ** -24, 3.0], dtype=torch.float32)
    assert torch.equal(_round_toward_zero(x), want)
