"""Roofline terms for the port: the chips' rates (``hardware``: the TPU
v5e and the H100), the aggregation kernels' byte and FLOP model
(``kernels``) and the analytic per-(architecture x shape) terms
(``analytic``).

Counterpart of ``repro.roofline`` without ``analysis.py``, which parses
XLA's compiled HLO and has no PyTorch counterpart (ROADMAP.md section 3,
departure 15).
"""

from repro_torch.roofline.hardware import H100, TPU_V5E
from repro_torch.roofline.kernels import (KernelTraffic, fed_reduce_traffic,
                                          fed_reduce_separate_traffic)

__all__ = ["TPU_V5E", "H100", "KernelTraffic", "fed_reduce_traffic",
           "fed_reduce_separate_traffic"]
