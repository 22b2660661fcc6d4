"""The kernel entry points the rest of the port calls (``repro.kernels.ops``'
counterpart).  Each dispatches on its tensor's device: the plain PyTorch
version on the CPU, the hand-written Hopper kernel on CUDA.
"""

from repro_torch.kernels.fed_aggregate import fed_aggregate  # noqa: F401
from repro_torch.kernels.fed_reduce import fed_reduce  # noqa: F401
from repro_torch.kernels.flash_attention import flash_attention  # noqa: F401
from repro_torch.kernels.rglru_scan import rglru_scan  # noqa: F401
