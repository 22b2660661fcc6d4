"""fed_reduce: fused segment aggregation over a packed cohort.

    out[t] = base[t] + sum_{m : seg[m] == t, in pack order} w~_m * rt(row_m)

Replaces the Pallas TPU kernel ``src/repro/kernels/fed_reduce.py::_kernel``
(wrapper ``fed_reduce``, ``pl.pallas_call`` at line 88) together with the
two pre-passes of the same jit (``kernels/ref.py``): the weight
normalisation and the int8 upload round trip ``rt`` (``_quant_rows``).
The Hopper kernels are in ``csrc/fed_reduce.cu``: ``fed_reduce_f32``, and
``fed_reduce_quant_f32`` when ``quant_ref`` is given.  The round trip's
scale reduces over a whole leaf of a row, across column tiles, so its call
is one cooperative launch of a persistent grid (the blocks that fit on the
card at once) in three phases with a grid barrier after each of the first
two: the blocks zero the (M, L) scratch, take each (row, leaf)'s max
|row - quant_ref| with the rows streamed through a ``cp.async`` ring and
flushed by ``atomicMax`` on the bits, then run the fold, each piece of
listed rows with its scales staged in shared memory and each enabled row
round-tripped as it leaves the ring (the rounded rows never touch memory).
No memset and no second kernel; a grid the card cannot hold at once is
refused and raises here.  The maxes are order-free and the fold keeps pack
order, so the result is bit for bit the plain version's,
``ref.fed_reduce_ref``.

What bounds it on the H100: bytes.  Each row element is read once for one
multiply and one add (0.5 FLOP per byte), so the least time is the bytes
moved (M*N rows + T*N base read, T*N written; with the round trip also
T*N of quant_ref) over 3.35 TB/s; the round trip's second read of the
enabled rows comes from the 50 MB L2 at the main path's sizes.  The
kernel keeps each thread's rows in flight (a batch of rows loaded before
any is folded, the next batch issued before the current one is folded,
row loads first at T = 1), lists a segment's rows with warp ballots
instead of a serial walk, and takes any number of rows: the list is held
in pieces (see the source's note).
Segment ids must lie in [0, num_segments), as for the plain version; at
T = 1 the kernel does not read them.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises.  ``launches`` counts the fold's launches (with and
without the round trip), ``quant_launches`` the calls that ran the round
trip (``fed_reduce_quant_f32``: one launch of its three phases).
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.kernels import ref
from repro_torch.roofline.analysis import kernel_op
from repro_torch.roofline.kernels import fed_reduce_launch_traffic

# Launches of the CUDA kernels in this process (set them to 0 to start a
# count): the fold, and the calls of it that ran the int8 round trip.
launches = 0
quant_launches = 0


def _cost(weights, rows, segments, num_segments, base=None, *,
          leaf_sizes=None, quant_ref=None, **_):
    """A launch's traffic and the int8 round trip's scratch of M x L + 1
    words (``quant_scratch``; ``roofline.analysis.kernel_op``)."""
    m, n = rows.shape
    quant = quant_ref is not None
    return (fed_reduce_launch_traffic(m, n, int(num_segments), quant=quant,
                                      base=base is not None),
            4 * (m * len(leaf_sizes) + 1) if quant and leaf_sizes else 0)


@kernel_op(_cost)
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
    quant = None
    if quant_ref is not None:
        quant = quant_inputs(rows, int(num_segments), leaf_sizes, quant_ref,
                             quant_enabled)
    return _launch(weights, rows, segments, num_segments, base, normalize,
                   quant)


@functools.lru_cache(maxsize=64)
def leaf_offsets(leaf_sizes: Tuple[int, ...],
                 device: torch.device) -> torch.Tensor:
    """(L + 1,) int32 on ``device``: each leaf's first column, then N.
    Cached per (leaf_sizes, device), so a call copies nothing to the
    device once its model's leaves have been seen."""
    off = [0]
    for size in leaf_sizes:
        off.append(off[-1] + size)
    return torch.tensor(off, dtype=torch.int32, device=device)


@functools.lru_cache(maxsize=64)
def _leaf_total(leaf_sizes: Tuple[int, ...]) -> int:
    """The columns the leaves cover, or -1 if a leaf is empty (cached: a
    model's split is checked once)."""
    return sum(leaf_sizes) if leaf_sizes and min(leaf_sizes) > 0 else -1


def quant_inputs(rows: torch.Tensor, num_segments: int,
                 leaf_sizes: Optional[Sequence[int]],
                 quant_ref: torch.Tensor,
                 quant_enabled: Optional[torch.Tensor]):
    """The round trip's inputs for ``fed_reduce_quant_f32``, checked before
    any launch: the cached leaf offsets, quant_ref as (T, N) float32, the
    mask as (M,) uint8 (a view of the bool mask; None: every row).  Raises
    ValueError on a leaf split that does not cover N with non-empty
    leaves, a quant_ref that is not (T, N) float32 on the rows' device, or
    a mask that is not (M,) bool."""
    if rows.dim() != 2:
        raise ValueError(f"rows must be (M, N), got {tuple(rows.shape)}")
    m, n = rows.shape
    if leaf_sizes is None:
        raise ValueError("the int8 round trip needs leaf_sizes")
    sizes = leaf_sizes if isinstance(leaf_sizes, tuple) else tuple(leaf_sizes)
    if _leaf_total(sizes) != n:
        raise ValueError(f"leaf_sizes must be positive and sum to N={n}, "
                         f"got {len(sizes)} leaves summing to {sum(sizes)}")
    if quant_ref.shape != (num_segments, n) \
            or quant_ref.dtype != torch.float32 \
            or quant_ref.device != rows.device:
        raise ValueError(f"quant_ref must be a ({num_segments}, {n}) float32 "
                         f"tensor on {rows.device}, got "
                         f"{tuple(quant_ref.shape)} {quant_ref.dtype} on "
                         f"{quant_ref.device}")
    enabled = None
    if quant_enabled is not None:
        if quant_enabled.shape != (m,) or quant_enabled.dtype != torch.bool:
            raise ValueError(f"quant_enabled must be a ({m},) bool tensor, "
                             f"got {tuple(quant_enabled.shape)} "
                             f"{quant_enabled.dtype}")
        # a bool is one byte, 0 or 1: the kernel reads it as uint8 where
        # it lies (a view, no cast kernel)
        enabled = quant_enabled.to(rows.device).contiguous().view(
            torch.uint8)
    return (quant_ref.contiguous(), enabled,
            leaf_offsets(sizes, rows.device), len(sizes))


def quant_scratch(m: int, n_leaves: int, device) -> torch.Tensor:
    """The scratch ``fed_reduce_quant_f32`` takes: each (row, leaf)'s max
    |row - quant_ref| and the fold's item counter after them, M * L + 1
    words that the kernel zeroes itself."""
    return torch.empty(m * n_leaves + 1, dtype=torch.int32, device=device)


def _launch(weights, rows, segments, num_segments, base, normalize,
            quant=None):
    global launches, quant_launches
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
    stream = torch.cuda.current_stream(dev).cuda_stream
    base_ptr = None if base is None else base.data_ptr()
    if quant is None:
        err = build.library().fed_reduce_f32(
            w.data_ptr(), rows.data_ptr(), seg.data_ptr(), base_ptr,
            out.data_ptr(), m, n, t, int(bool(normalize)), dev.index or 0,
            stream)
    else:
        qref, enabled, off, n_leaves = quant
        scratch = quant_scratch(m, n_leaves, dev)
        err = build.library().fed_reduce_quant_f32(
            w.data_ptr(), rows.data_ptr(), seg.data_ptr(), base_ptr,
            out.data_ptr(), qref.data_ptr(),
            None if enabled is None else enabled.data_ptr(), off.data_ptr(),
            n_leaves, scratch.data_ptr(), m, n, t, int(bool(normalize)),
            dev.index or 0, stream)
    if err != 0:
        raise RuntimeError(f"fed_reduce kernel launch failed: CUDA error {err}")
    launches += 1
    if quant is not None:
        quant_launches += 1
    return out
