"""Analytic byte/FLOP model for the federated aggregation kernels.

``fed_reduce`` is a streaming reduction: arithmetic intensity is well
under 1 FLOP/byte, so its roofline is the memory term alone — the wall
time lower bound on a chip is ``bytes / hbm_bandwidth``.  The byte model
below is what ``benchmarks/kernel_bench.py`` checks measured time
against (``bound_fraction`` = bound / measured: 1.0 means streaming at
bandwidth), both for the host CPU (against a measured stream rate) and
analytically for TPU_V5E.

The fused kernel's traffic for (M, N) rows into (T, N) lanes:

  read   rows        M * N * 4 bytes    (streamed exactly once)
  read   quant_ref   T * N * 4          (only when the round trip fuses;
                                         the (M, N) gather re-reads it
                                         from cache/VMEM, counted once)
  read   base        T * N * 4
  write  out         T * N * 4

versus the pre-fusion separate-call sequence, which streams the rows
once per stage (quantize round trip: read + write; weighted reduce:
read) plus each stage's lane-sized traffic — the rows term alone is
~3x, which is the whole speedup story for M >> T.

Copy of ``repro.roofline.kernels``; the port imports nothing of ``repro``.
The default chip stays ``TPU_V5E``: pass ``hardware.H100`` for the card.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.roofline.hardware import TPU_V5E, Chip

F32 = 4


@dataclass(frozen=True)
class KernelTraffic:
    """HBM traffic + FLOPs of one kernel dispatch (or call sequence)."""
    name: str
    bytes_hbm: float
    flops: float

    def bound_s(self, chip: Chip = TPU_V5E) -> float:
        """Roofline wall-time lower bound on ``chip`` (memory term vs
        compute term — for these kernels the memory term always wins)."""
        return max(self.bytes_hbm / chip.hbm_bandwidth,
                   self.flops / chip.peak_flops_bf16)

    def bound_s_at(self, stream_bytes_per_s: float) -> float:
        """Memory-roofline bound at a measured stream bandwidth (the CPU
        path of the kernel benchmark)."""
        return self.bytes_hbm / stream_bytes_per_s


def fed_reduce_traffic(m: int, n: int, t: int, *, quant: bool = False,
                       base: bool = True) -> KernelTraffic:
    """Fused kernel: one pass over the rows, lane-sized side inputs."""
    b = m * n * F32                        # rows, streamed once
    if quant:
        b += t * n * F32                   # quant_ref
    if base:
        b += t * n * F32                   # base
    b += t * n * F32                       # out
    # weight mul + fold add per element, plus ~6 elementwise ops for the
    # quantization round trip (sub, div, round, clip, mul, add)
    f = 2.0 * m * n + (6.0 * m * n if quant else 0.0)
    return KernelTraffic("fed_reduce_fused", float(b), f)


def fed_reduce_separate_traffic(m: int, n: int, t: int, *,
                                quant: bool = False,
                                base: bool = True) -> KernelTraffic:
    """The pre-fusion sequence: per-trial quantize round trip (read rows
    + refs, write rows), then per-trial weighted reduce (read rows again,
    write lanes), then lane base add.  Rows stream ~3x."""
    b = m * n * F32                        # reduce: read rows
    f = 2.0 * m * n
    if quant:
        b += 2 * m * n * F32               # roundtrip: read + write rows
        b += t * n * F32                   # refs
        f += 6.0 * m * n
    if base:
        b += 2 * t * n * F32               # base add: read lanes + base
        f += t * n
    b += t * n * F32                       # out
    return KernelTraffic("fed_reduce_separate", float(b), f)


def fed_reduce_launch_traffic(m: int, n: int, t: int, *, quant: bool = False,
                              base: bool = True) -> KernelTraffic:
    """One ``fed_reduce`` launch on the card: ``fed_reduce_traffic``'s
    bytes plus what they leave out, the (M,) f32 weights and int32
    segments and, with the round trip, the (M,) int8 mask; a multiply and
    an add an element of the rows and the base's add (the round trip's
    few operations an element leave it bound by bytes all the same)."""
    fused = fed_reduce_traffic(m, n, t, quant=quant, base=base)
    return KernelTraffic("fed_reduce",
                         fused.bytes_hbm + 8 * m + (m if quant else 0),
                         2.0 * m * n + (t * n if base else 0))


def fed_aggregate_traffic(m: int, n: int, *,
                          base: bool = True) -> KernelTraffic:
    """One ``fed_aggregate`` launch: the (M, N) f32 deltas and (M,)
    weights read once, the (N,) base read and the (N,) result written;
    a multiply and an add an element, and the base's add."""
    return KernelTraffic("fed_aggregate",
                         float(F32 * (m * n + m + (2 if base else 1) * n)),
                         2.0 * m * n + (n if base else 0))


# ---------------------------------------------------------------------------
# the LM kernels (flash_attention, rglru_scan): what PERF.md's bounds count
# ---------------------------------------------------------------------------

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


def attention_scratch_bytes(b: int, h: int, kh: int, s: int, t: int, d: int,
                            *, esize: int, backward: bool = False) -> int:
    """The scratch the wrapper allocates for one call, as the kernels'
    planners size it: the f32 forward's TF32 planes of K and V (16-key
    tiles, 64 d floats each), none for the bf16 forward; the backward's
    row tiles (Q, dO, lse, delta) and key tiles (K, V; TF32 hi/lo planes
    in f32) (``flash_attention_bwd_plan_f32`` / ``_plan_bf16``)."""
    if not backward:
        return 0 if esize == 2 else 4 * b * kh * -(-t // 16) * 64 * d
    heads, n_rt = b * kh, -(-(s * (h // kh)) // 64)
    if esize == 2:
        n_kt = -(-t // 64)
        return heads * (n_rt * (4 * 64 * d + 8 * 64) + n_kt * 4 * 64 * d)
    dc = min(d, 64)
    n_kt, nc = -(-t // 32), d // dc
    return 4 * heads * nc * (n_rt * (2 * 64 + 2 * 64 * dc)
                             + n_kt * 4 * 32 * dc)


def rglru_scan_traffic(b: int, t: int, w: int, *, esize: int,
                       backward: bool = False) -> KernelTraffic:
    """One ``rglru_scan`` call over (B, T, W): the forward reads a and b
    and writes h (2 FLOP an element); the reverse scan (f32) reads a, h
    and dh and writes da and db (3 FLOP an element)."""
    n = b * t * w
    if backward:
        return KernelTraffic("rglru_scan_bwd", float(20 * n), 3.0 * n)
    return KernelTraffic("rglru_scan", float(3 * esize * n), 2.0 * n)
