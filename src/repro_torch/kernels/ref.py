"""Plain-PyTorch versions of the kernels (the ground truth in tests).

Counterparts of ``repro.kernels.ref`` with its op order kept exactly, so on
the same f32 inputs they give the same bits:

  * ``wx = w * x`` is materialised BEFORE the fold, so the fold body is a
    plain f32 add and nothing can be contracted into an FMA;
  * each segment's fold is a strict left-to-right ``+=`` over its rows in
    pack order, so lane t of a T-segment call equals a T=1 call over the
    same rows (packing invariance);
  * normalisation is an IEEE division by the segment's sequentially folded
    weight total, and empty segments divide by 1;
  * the int8 round trip follows the reference's jitted graph as XLA
    compiles it: ``max|d| / 127`` becomes a multiply by the f32 reciprocal
    of 127 (``RECIP_127``), values round half to even (``torch.round``, as
    ``jnp.round``), and ``g + q * scale`` is one fused multiply-add.

The LM zoo's ``flash_attention_ref`` and ``rglru_scan_ref`` follow at the
end, with their backward passes ``flash_attention_bwd_ref`` and
``rglru_scan_bwd_ref``.  They take f32 or bf16 inputs and compute in f32,
as the TPU kernels and the reference's jnp gradient do, returning the
inputs' dtype (lse always f32): on bf16 inputs the one rounding to bf16 is
at the end, and on f32 inputs the results are the same bits as ever.  On a CPU tensor the kernel wrappers
(``fed_reduce.py``, ``fed_aggregate.py``, ``flash_attention.py``,
``rglru_scan.py``) run these functions; on the card the kernels are held
against them.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.sharding.ctx import steps

# XLA rewrites a division by the constant 127 into a multiply by its f32
# reciprocal; the port multiplies by the same f32 value.
RECIP_127 = float(np.float32(1.0) / np.float32(127.0))


def fed_aggregate_ref(weights: torch.Tensor, deltas: torch.Tensor,
                      base: Optional[torch.Tensor] = None) -> torch.Tensor:
    """weights: (M,), deltas: (M, N) -> (N,).  Optionally adds ``base``.
    Folds ``w_m * delta_m`` from 0 in row order, then adds ``base``."""
    w = weights.to(torch.float32)
    x = deltas.to(torch.float32)
    out = torch.zeros(x.shape[1], dtype=torch.float32, device=x.device)
    for m in range(x.shape[0]):
        out = out + w[m] * x[m]
    if base is not None:
        out = out + base.to(torch.float32)
    return out.to(deltas.dtype)


def _fma_f32(a: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` on f32 tensors, rounded ONCE to f32 (a fused
    multiply-add).  The reference's jitted dequantisation ``g + q * scale``
    is contracted into an FMA by XLA, and PyTorch has no FMA op, so this
    emulates one exactly: the product of two f32 values is exact in f64,
    the f64 sum is rounded to odd (its exact error from TwoSum decides),
    and rounding an odd-rounded f64 to f32 is correctly rounded."""
    p = a.to(torch.float64) * b.to(torch.float64)
    q = c.to(torch.float64)
    s = p + q
    bb = s - p
    err = (p - (s - bb)) + (q - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, float("-inf")))
    nudge = (err != 0) & even & torch.isfinite(s)
    return torch.where(nudge, torch.nextafter(s, toward), s).to(torch.float32)


def _quant_rows(rows: torch.Tensor, segments: torch.Tensor,
                quant_ref: torch.Tensor,
                quant_enabled: Optional[torch.Tensor],
                leaf_sizes: Sequence[int]) -> torch.Tensor:
    """The int8 upload round trip on flat (M, N) rows, per (row, leaf)
    scale ``max(max|d|/127, 1e-12)``; row m is quantised against
    ``quant_ref[seg[m]]``.  Rows with ``quant_enabled`` False pass
    through untouched."""
    x = rows.to(torch.float32)
    g = quant_ref.to(torch.float32)[segments.long()]        # (M, N) gather
    d = x - g
    m = rows.shape[0]
    scales = []
    off = 0
    for size in leaf_sizes:
        leaf_max = d[:, off:off + size].abs().amax(dim=1)
        scales.append(torch.clamp_min(leaf_max * RECIP_127, 1e-12))
        off += size
    col_scale = torch.cat([s[:, None].expand(m, size)
                           for s, size in zip(scales, leaf_sizes)], dim=1)
    q = torch.clamp(torch.round(d / col_scale), -127, 127).to(torch.int8)
    rec = _fma_f32(q.to(torch.float32), col_scale, g)
    if quant_enabled is None:
        return rec
    return torch.where(quant_enabled.to(torch.bool)[:, None], rec, x)


def _seg_fold(values: torch.Tensor, segments: Sequence[int],
              num_segments: int) -> torch.Tensor:
    """Left-to-right fold of rows into per-segment f32 accumulators.
    values: (M,) or (M, N); segments: M host ints.  Each accumulator only
    sees its own segment's rows, in pack order."""
    acc = torch.zeros((num_segments,) + tuple(values.shape[1:]),
                      dtype=torch.float32, device=values.device)
    v = values.to(torch.float32)
    for m, s in enumerate(segments):
        acc[s] = acc[s] + v[m]
    return acc


def _norm_weights(weights: torch.Tensor, segments: Sequence[int],
                  num_segments: int, normalize: bool) -> torch.Tensor:
    """f32 weights, divided by their per-segment totals when asked.  The
    totals are the same sequential fold; empty segments divide by 1."""
    w = weights.to(torch.float32)
    if not normalize:
        return w
    tot = _seg_fold(w, segments, num_segments)
    tot = torch.where(tot > 0, tot, torch.ones_like(tot))
    return w / tot[list(segments)]


def fed_reduce_ref(weights: torch.Tensor, rows: torch.Tensor,
                   segments: torch.Tensor, num_segments: int,
                   base: Optional[torch.Tensor] = None, *,
                   normalize: bool = False,
                   leaf_sizes: Optional[Sequence[int]] = None,
                   quant_ref: Optional[torch.Tensor] = None,
                   quant_enabled: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """Fused segment aggregation over a packed multi-trial flat cohort.

    weights: (M,), rows: (M, N), segments: (M,) int trial slots ->
    (num_segments, N): ``out[t] = base[t] + sum_{seg[m]=t} w~_m * x_m``
    with the optional int8 round trip against ``quant_ref`` and weight
    normalisation, in ``repro.kernels.ref.fed_reduce_ref``'s op order."""
    seg_host = [int(s) for s in segments.tolist()]
    x = rows.to(torch.float32)
    if quant_ref is not None:
        x = _quant_rows(x, segments, quant_ref, quant_enabled, leaf_sizes)
    w = _norm_weights(weights, seg_host, num_segments, normalize)
    wx = w[:, None] * x
    out = _seg_fold(wx, seg_host, num_segments)
    if base is not None:
        out = out + base.to(torch.float32)
    return out.to(rows.dtype)


# LM zoo kernels: the plain versions of ``flash_attention`` and
# ``rglru_scan`` (``repro.kernels.ref.flash_attention_ref`` and
# ``rglru_scan_ref``).  Masked scores take -1e30 (not -inf), and query i
# attends keys ``k <= i + (T - S)``, as in the reference.

NEG_INF = -1e30


def _attn_mask(s: int, t: int, causal: bool, window: Optional[int], device
               ) -> torch.Tensor:
    """(S, T) bool: query i (at key position i + T - S) sees key j."""
    q_pos = torch.arange(s, device=device)[:, None] + (t - s)
    k_pos = torch.arange(t, device=device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    return mask


def _attn_scores(q, k, causal, window, cap):
    """Capped and masked scores (B, Kh, G, S, T) in f32, the mask, and
    d(capped)/d(raw) (None without a cap)."""
    b, h, s, d = q.shape
    kh, t = k.shape[1], k.shape[2]
    qr = q.reshape(b, kh, h // kh, s, d).to(torch.float32)
    scores = torch.einsum("bkgsd,bktd->bkgst", qr, k.to(torch.float32))
    scores = scores * (d ** -0.5)
    dcap = None
    if cap is not None:
        th = torch.tanh(scores / cap)
        scores = cap * th
        dcap = 1.0 - th * th
    mask = _attn_mask(s, t, causal, window, q.device)
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    return scores, mask, dcap


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None,
                        cap: Optional[float] = None, return_lse: bool = False):
    """q: (B, H, S, D); k, v: (B, Kh, T, D) with H % Kh == 0 -> (B, H, S, D).
    Materialises the (S, T) scores in f32; the output has q's dtype.  With
    ``return_lse`` also the rows' log-sum-exp (B, H, S) in f32,
    ``m + log(max(l, 1e-30))`` as the reference's ``_flash_forward``."""
    b, h, s, d = q.shape
    scores, _, _ = _attn_scores(q, k, causal, window, cap)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,bktd->bkgsd", p, v.to(torch.float32))
    out = out.reshape(b, h, s, d).to(q.dtype)
    if not return_lse:
        return out
    m = scores.amax(dim=-1)
    l = torch.exp(scores - m[..., None]).sum(dim=-1)
    lse = m + torch.log(torch.clamp_min(l, 1e-30))
    return out, lse.reshape(b, h, s)


def flash_attention_bwd_ref(q, k, v, out, lse, dout, *, causal: bool = True,
                            window: Optional[int] = None,
                            cap: Optional[float] = None):
    """The attention's gradient, (dq, dk, dv), from the forward's ``out``
    and ``lse`` (B, H, S) and the output's gradient ``dout`` (B, H, S, D):
    ``repro.models.attention._flash_backward``'s maths over the whole
    (S, T) score matrix in f32, with the kernel's alignment (query i at key
    i + T - S).  delta = rowsum(dout * out), P = exp(s - lse),
    dS = P (dP - delta), times 1 - tanh^2 of the raw score under a cap and
    zero where the mask is off; a kv head's dk and dv sum its G heads."""
    b, h, s, d = q.shape
    kh, t = k.shape[1], k.shape[2]
    g = h // kh
    scale = d ** -0.5
    f32 = torch.float32
    scores, mask, dcap = _attn_scores(q, k, causal, window, cap)
    do = dout.reshape(b, kh, g, s, d).to(f32)
    delta = torch.einsum("bkgsd,bkgsd->bkgs", do,
                         out.reshape(b, kh, g, s, d).to(f32))
    p = torch.exp(scores - lse.reshape(b, kh, g, s, 1).to(f32))
    dp = torch.einsum("bkgsd,bktd->bkgst", do, v.to(f32))
    ds = p * (dp - delta[..., None])
    if dcap is not None:
        ds = ds * dcap
    ds = torch.where(mask, ds, torch.zeros_like(ds))
    qr = q.reshape(b, kh, g, s, d).to(f32)
    dq = torch.einsum("bkgst,bktd->bkgsd", ds, k.to(f32)) * scale
    dk = torch.einsum("bkgst,bkgsd->bktd", ds, qr) * scale
    dv = torch.einsum("bkgst,bkgsd->bktd", p, do)
    return (dq.reshape(b, h, s, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
def rglru_scan_ref(a: torch.Tensor, b: torch.Tensor,
                   h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t over axis 1; a, b: (B, T, W) -> (B, T, W).
    A sequential loop in f32 that rounds ``a_t * h`` before the add (no
    fused multiply-add), so the kernel matches it bit for bit.  The state
    stays f32; on bf16 inputs each h_t is rounded to bf16 once, at its
    store, as the Pallas step stores it."""
    bsz, t, w = a.shape
    af = a.to(torch.float32)
    bf = b.to(torch.float32)
    h = (torch.zeros((bsz, w), dtype=torch.float32, device=a.device)
         if h0 is None else h0.to(torch.float32))
    out = torch.empty((bsz, t, w), dtype=torch.float32, device=a.device)
    for i in steps(t, a.device):
        h = af[:, i] * h + bf[:, i]
        out[:, i] = h
    return out.to(a.dtype)


def rglru_scan_bwd_ref(a: torch.Tensor, h: torch.Tensor, dh: torch.Tensor):
    """The scan's gradient: (da, db) from the coefficients ``a``, the
    forward's output ``h`` and its gradient ``dh``, all (B, T, W).  A
    reverse sequential loop in f32, each product rounded before the add
    (no fused multiply-add), as the kernel runs it:
    g_t = dh_t + a_{t+1} * g_{t+1} (from a_T = g_T = 0), db_t = g_t and
    da_t = g_t * h_{t-1} with h_{-1} = 0."""
    bsz, t, w = a.shape
    f32 = torch.float32
    af, hf, dhf = a.to(f32), h.to(f32), dh.to(f32)
    g = torch.zeros((bsz, w), dtype=f32, device=a.device)
    a_next = torch.zeros_like(g)
    zero = torch.zeros_like(g)
    da = torch.empty((bsz, t, w), dtype=f32, device=a.device)
    db = torch.empty_like(da)
    for j in steps(t, a.device):
        i = t - 1 - j
        g = dhf[:, i] + a_next * g
        db[:, i] = g
        da[:, i] = g * (hf[:, i - 1] if i > 0 else zero)
        a_next = af[:, i]
    return da.to(a.dtype), db.to(a.dtype)
