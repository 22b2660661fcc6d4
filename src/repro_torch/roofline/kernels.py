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
