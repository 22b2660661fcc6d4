"""The kernel entry points the rest of the port calls (``repro.kernels.ops``'
counterpart).  Each dispatches on its tensor's device: the plain PyTorch
version on the CPU, the hand-written Hopper kernel on CUDA.

``flash_attention`` and ``rglru_scan`` belong to the LM zoo and are ported
with it (see ROADMAP.md).
"""

from repro_torch.kernels.fed_aggregate import fed_aggregate  # noqa: F401
from repro_torch.kernels.fed_reduce import fed_reduce  # noqa: F401
