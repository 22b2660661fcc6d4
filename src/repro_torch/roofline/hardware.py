"""Target hardware constants (TPU v5e, and the H100 the port runs on).

Copy of ``repro.roofline.hardware`` with an H100 beside the TPU; the port
imports nothing of ``repro``.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Chip:
    name: str
    peak_flops_bf16: float     # FLOP/s per chip
    hbm_bandwidth: float       # B/s per chip
    ici_link_bandwidth: float  # B/s per link
    ici_links_per_chip: int    # usable links on the 2D torus
    hbm_bytes: float


TPU_V5E = Chip(
    name="tpu_v5e",
    peak_flops_bf16=197e12,
    hbm_bandwidth=819e9,
    ici_link_bandwidth=50e9,
    ici_links_per_chip=2,      # effective concurrent links for ring collectives
    hbm_bytes=16e9,
)

# NVIDIA H100 SXM5 80GB data sheet, 700 W.  On this card the ``ici_*``
# fields stand for NVLink 4: 18 links a card, 900 GB/s counted in both
# directions.  A card sends its share of a ring or NVSwitch collective in
# one direction, so each link counts at its one-way 25 GB/s (450 GB/s a
# card), as ``AnalyticReport.terms`` divides by the links' sum.
H100 = Chip(
    name="h100_sxm5",
    peak_flops_bf16=989e12,    # bf16 tensor cores, dense (data sheet, 700 W)
    hbm_bandwidth=3.35e12,     # HBM3 (data sheet, 700 W)
    ici_link_bandwidth=25e9,   # one NVLink 4 link, one direction (data sheet)
    ici_links_per_chip=18,     # NVLink 4 links a card (data sheet)
    hbm_bytes=80e9,            # HBM3 (data sheet)
)

# NVIDIA H100 SXM5 80GB data sheet, 700 W: the rates that are not bf16
H100_F32_FLOPS_PER_S = 67e12     # f32 outside the tensor cores
H100_TF32_FLOPS_PER_S = 495e12   # TF32 tensor cores, dense
