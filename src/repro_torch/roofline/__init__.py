"""Roofline terms for the port: the chips' rates (``hardware``: the TPU
v5e and the H100), the kernels' byte and FLOP model (``kernels``), the
analytic per-(architecture x shape) terms (``analytic``) and the per-rank
analysis of a step the port runs (``analysis``, the counterpart of the
reference's analysis of a compiled program).
"""

from repro_torch.roofline.analysis import RooflineReport, analyze_traced
from repro_torch.roofline.hardware import H100, TPU_V5E
from repro_torch.roofline.kernels import (KernelTraffic, fed_reduce_traffic,
                                          fed_reduce_separate_traffic)

__all__ = ["TPU_V5E", "H100", "KernelTraffic", "fed_reduce_traffic",
           "fed_reduce_separate_traffic", "RooflineReport", "analyze_traced"]
