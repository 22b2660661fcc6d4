"""The yardstick's operation and byte counts, frozen here.

``live_pairs`` and ``attention_traffic`` are copies of
``src/repro_torch/roofline/kernels.py`` (of the same names); the harness
never calls the program's copies.  The model counts are what a cell's model
requires, not what the program executes: 2 FLOP a multiply-add of the
matrix parameters a token uses (a mixture of experts at its top k of E
experts, the router counted) and causal attention at 4 D FLOP a live
(query, key) pair, with no dense-expert overcompute.  Bytes are each weight read
once at its dtype and each cache entry read or written once.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

# one NVIDIA H100 SXM (data sheet, dense): bf16 tensor cores and HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


@dataclass(frozen=True)
class KernelTraffic:
    """HBM traffic and FLOPs of one kernel launch."""
    name: str
    bytes_hbm: float
    flops: float

    def bound_s(self) -> float:
        return max(self.bytes_hbm / PEAK_HBM_BYTES,
                   self.flops / PEAK_BF16_FLOPS)


def _series(lo: int, hi: int, c0: int, c1: int) -> int:
    """sum of c0 + c1 * x over the integers lo <= x <= hi."""
    if hi < lo:
        return 0
    k = hi - lo + 1
    return c0 * k + c1 * (lo + hi) * k // 2


def live_pairs(s: int, t: int, causal: bool, window) -> int:
    """(query, key) pairs the mask keeps for one (batch, head), query i at
    key position x = i + (t - s): keys [max(0, x - window + 1), x] when
    causal, else up to t - 1.  Summed in closed form over x in
    [t - s, t - 1]."""
    x0, x1 = t - s, t - 1
    if causal:
        if window is None:
            return _series(max(x0, 0), x1, 1, 1)              # x + 1 keys
        return (_series(max(x0, 0), min(x1, window - 2), 1, 1)
                + _series(max(x0, window - 1), x1, window, 0))
    if window is None:
        return s * t
    return (_series(x0, min(x1, window - 1), t, 0)
            + _series(max(x0, window), x1, t + window - 1, -1))


def attention_traffic(b: int, h: int, kh: int, s: int, t: int, d: int, *,
                      causal: bool, window, esize: int,
                      backward: bool = False,
                      lse: bool = False) -> KernelTraffic:
    """One ``flash_attention`` call, q (B, H, S, D), k and v (B, Kh, T, D)
    of ``esize``-byte elements.  Forward: 4 D FLOP a live pair (Q K^T and
    P V), q, k, v read and the output written (and the rows' f32 lse with
    ``lse``).  Backward: 10 D FLOP a live pair (the scores again, dP, dV,
    dQ, dK), q, k, v, out and dout read with the f32 lse, dq, dk, dv
    written."""
    pairs = live_pairs(s, t, causal, window) * b * h
    if backward:
        nbytes = esize * d * (4 * b * h * s + 4 * b * kh * t) + 4 * b * h * s
        return KernelTraffic("flash_attention_bwd", float(nbytes),
                             10.0 * d * pairs)
    nbytes = esize * d * (2 * b * h * s + 2 * b * kh * t) \
        + (4 * b * h * s if lse else 0)
    return KernelTraffic("flash_attention", float(nbytes), 4.0 * d * pairs)


# ---------------------------------------------------------------------------
# what a cell's model requires
# ---------------------------------------------------------------------------

def layer_matrix_params(c: Dict) -> int:
    """Matrix parameters one token uses in one layer: q, k, v, o and the
    FFN (a MoE's top k experts and its router)."""
    d, hd = c["d_model"], c["head_dim"]
    attn = d * hd * (2 * c["n_heads"] + 2 * c["n_kv_heads"])
    moe = c.get("moe")
    if moe:
        ffn = moe["top_k"] * 3 * d * moe["d_ff_expert"] + d * moe["n_experts"]
    else:
        ffn = 3 * d * c["d_ff"]
    return attn + ffn


def param_count(c: Dict) -> int:
    """Every parameter of the model (all experts)."""
    d, hd, l = c["d_model"], c["head_dim"], c["n_layers"]
    attn = d * hd * (2 * c["n_heads"] + 2 * c["n_kv_heads"])
    if c["qkv_bias"]:
        attn += hd * (c["n_heads"] + 2 * c["n_kv_heads"])
    moe = c.get("moe")
    ffn = (moe["n_experts"] * 3 * d * moe["d_ff_expert"]
           + d * moe["n_experts"]) if moe else 3 * d * c["d_ff"]
    n = l * (attn + ffn + 2 * d) + d + c["vocab_size"] * d
    if not c["tie_embeddings"]:
        n += c["vocab_size"] * d
    return n


def head_params(c: Dict) -> int:
    return c["d_model"] * c["vocab_size"]


def attn_flops(c: Dict, b: int, s: int, t: int) -> float:
    """Forward attention FLOPs over all layers: 4 D a live pair."""
    pairs = live_pairs(s, t, True, None)
    return 4.0 * c["head_dim"] * c["n_heads"] * c["n_layers"] * pairs * b


def kv_bytes_per_position(c: Dict, esize: int = 2) -> int:
    """K and V of one position in every layer."""
    return 2 * c["n_layers"] * c["n_kv_heads"] * c["head_dim"] * esize


def step_counts(c: Dict, kind: str, t: Dict) -> Dict[str, float]:
    """One timed step's required FLOPs and bytes (``flops``, ``bytes``),
    and for prefill the attention kernel's bound a launch
    (``attn_fwd_bound_s``), for the entry ``kind`` with traffic ``t``."""
    lm, hp = c["n_layers"] * layer_matrix_params(c), head_params(c)
    n_par = param_count(c)
    h, kh, hd = c["n_heads"], c["n_kv_heads"], c["head_dim"]
    if kind == "prefill":
        b, s = t["batch"], t["prompt_len"]
        flops = 2.0 * lm * b * s + 2.0 * hp * b + attn_flops(c, b, s, s)
        nbytes = 2.0 * n_par + kv_bytes_per_position(c) * b * s
        fwd = attention_traffic(b, h, kh, s, s, hd, causal=True,
                                window=None, esize=2)
        return dict(flops=flops, bytes=nbytes, attn_fwd_bound_s=fwd.bound_s())
    if kind == "decode":
        b, ctx = t["batch"], t["prefix_len"]
        # at the window's mean context: the prefix and the steps so far
        ctx = ctx + t.get("mean_new_positions", 0)
        flops = 2.0 * (lm + hp) * b + 4.0 * hd * h * c["n_layers"] * ctx * b
        nbytes = 2.0 * n_par + kv_bytes_per_position(c) * b * (ctx + 1)
        return dict(flops=flops, bytes=nbytes)
    raise ValueError(kind)


def bound_s(flops: float, nbytes: float) -> float:
    """The least time one H100 could take: the larger of the two terms."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)
