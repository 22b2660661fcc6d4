"""fed_aggregate: weighted aggregation ``out = base + sum_m w_m * delta_m``.

Replaces the Pallas TPU kernel ``src/repro/kernels/fed_aggregate.py::_kernel``
(wrapper ``fed_aggregate``, ``pl.pallas_call`` at line 46).  The Hopper
kernel is ``csrc/fed_aggregate.cu``; its plain version is
``ref.fed_aggregate_ref``.  On the main path it carries the FedAsync mix of
async mode, with M = 1.

What bounds it on the H100: bytes.  Each delta element is read once for one
multiply and one add (0.5 FLOP per byte), so the least time is the bytes
moved (M*N deltas + N base read, N written) over 3.35 TB/s; at M = 1 the
launch costs more than the bytes.  A thread issues base, its rows and their
weights together, with the widest loads each row's alignment allows, and
folds in registers, in row order with no FMA, so it equals the plain
version bit for bit.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises.  ``launches`` counts the kernel's launches.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ref
from repro_torch.roofline.analysis import kernel_op
from repro_torch.roofline.kernels import fed_aggregate_traffic

# Launches of the CUDA kernel in this process (set it to 0 to start a count).
launches = 0


@kernel_op(lambda weights, deltas, base=None: (fed_aggregate_traffic(
    *deltas.shape, base=base is not None), 0))
def fed_aggregate(weights: torch.Tensor, deltas: torch.Tensor,
                  base: Optional[torch.Tensor] = None) -> torch.Tensor:
    """weights: (M,); deltas: (M, N); base: (N,) or None -> (N,)."""
    if deltas.device.type == "cpu":
        return ref.fed_aggregate_ref(weights, deltas, base)
    return _launch(weights, deltas, base)


def _launch(weights, deltas, base):
    global launches
    from repro_torch.kernels import build

    dev = deltas.device
    if dev.type != "cuda":
        raise ValueError(f"fed_aggregate kernel needs a CUDA tensor, got {dev}")
    if deltas.dim() != 2 or deltas.dtype != torch.float32 \
            or not deltas.is_contiguous():
        raise ValueError("deltas must be a contiguous (M, N) float32 tensor, "
                         f"got {tuple(deltas.shape)} {deltas.dtype}")
    m, n = deltas.shape
    w = weights.to(device=dev, dtype=torch.float32).contiguous()
    if w.shape != (m,):
        raise ValueError(f"weights must be ({m},), got {tuple(w.shape)}")
    if base is not None:
        if base.shape != (n,) or base.dtype != torch.float32 \
                or base.device != dev or not base.is_contiguous():
            raise ValueError(f"base must be a contiguous ({n},) float32 "
                             f"tensor on {dev}, got {tuple(base.shape)} "
                             f"{base.dtype} on {base.device}")
    out = torch.empty((n,), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    err = build.library().fed_aggregate_f32(
        w.data_ptr(), deltas.data_ptr(),
        None if base is None else base.data_ptr(), out.data_ptr(),
        m, n, dev.index or 0, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"fed_aggregate kernel launch failed: CUDA error {err}")
    launches += 1
    return out
