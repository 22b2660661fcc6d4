"""fed_reduce: fused segment aggregation over a packed cohort.

    out[t] = base[t] + sum_{m : seg[m] == t, in pack order} w~_m * rt(row_m)

Replaces the Pallas TPU kernel ``src/repro/kernels/fed_reduce.py::_kernel``
(wrapper ``fed_reduce``, ``pl.pallas_call`` at line 88) together with the
weight-normalisation pre-pass of the same jit (``kernels/ref.py``).  The
Hopper kernel is ``csrc/fed_reduce.cu``; its plain version is
``ref.fed_reduce_ref``.

What bounds it on the H100: bytes.  Each row element is read once for one
multiply and one add (0.5 FLOP per byte), so the least time is the bytes
moved (M*N rows + T*N base read, T*N written) over 3.35 TB/s.  The kernel
keeps each thread's rows in flight (a batch of rows loaded before any is
folded, the next batch issued before the current one is folded, row loads
first at T = 1), lists a segment's rows with warp ballots instead of a
serial walk, and takes any number of rows: the list is held in pieces (see
the source's note).  Segment ids must lie in [0, num_segments), as for the
plain version; at T = 1 the kernel does not read them.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises.  ``launches`` counts the kernel's launches.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.kernels import ref

# Launches of the CUDA kernel in this process (set it to 0 to start a count).
launches = 0


def fed_reduce(weights: torch.Tensor, rows: torch.Tensor,
               segments: torch.Tensor, num_segments: int,
               base: Optional[torch.Tensor] = None, *,
               normalize: bool = False,
               leaf_sizes: Optional[Sequence[int]] = None,
               quant_ref: Optional[torch.Tensor] = None,
               quant_enabled: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
    """weights: (M,); rows: (M, N); segments: (M,) -> (num_segments, N).
    Same contract as ``ref.fed_reduce_ref``, bit for bit."""
    if rows.device.type == "cpu":
        return ref.fed_reduce_ref(
            weights, rows, segments, num_segments, base,
            normalize=normalize, leaf_sizes=leaf_sizes, quant_ref=quant_ref,
            quant_enabled=quant_enabled)
    x = rows
    if quant_ref is not None:
        # a plain pre-pass before the kernel, as in JAX (outside the
        # pallas_call): the per-leaf scales reduce over whole rows
        x = ref._quant_rows(rows, segments, quant_ref, quant_enabled,
                            leaf_sizes)
    return _launch(weights, x, segments, num_segments, base, normalize)


def _launch(weights, rows, segments, num_segments, base, normalize):
    global launches
    from repro_torch.kernels import build

    dev = rows.device
    if dev.type != "cuda":
        raise ValueError(f"fed_reduce kernel needs a CUDA tensor, got {dev}")
    if rows.dim() != 2 or rows.dtype != torch.float32 \
            or not rows.is_contiguous():
        raise ValueError("rows must be a contiguous (M, N) float32 tensor, "
                         f"got {tuple(rows.shape)} {rows.dtype}")
    m, n = rows.shape
    t = int(num_segments)
    w = weights.to(device=dev, dtype=torch.float32).contiguous()
    seg = segments.to(device=dev, dtype=torch.int32).contiguous()
    if w.shape != (m,) or seg.shape != (m,):
        raise ValueError(f"weights and segments must be ({m},), got "
                         f"{tuple(w.shape)} and {tuple(seg.shape)}")
    if base is not None:
        if base.shape != (t, n) or base.dtype != torch.float32 \
                or base.device != dev or not base.is_contiguous():
            raise ValueError(f"base must be a contiguous ({t}, {n}) float32 "
                             f"tensor on {dev}, got {tuple(base.shape)} "
                             f"{base.dtype} on {base.device}")
    out = torch.empty((t, n), dtype=torch.float32, device=dev)
    if n == 0 or t == 0:
        return out
    err = build.library().fed_reduce_f32(
        w.data_ptr(), rows.data_ptr(), seg.data_ptr(),
        None if base is None else base.data_ptr(), out.data_ptr(),
        m, n, t, int(bool(normalize)), dev.index or 0,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fed_reduce kernel launch failed: CUDA error {err}")
    launches += 1
    return out
