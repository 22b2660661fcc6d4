"""rglru_scan: the RG-LRU diagonal recurrence ``h_t = a_t * h_{t-1} + b_t``.

Replaces the Pallas TPU kernel ``src/repro/kernels/rglru_scan.py::_kernel``
(wrapper ``rglru_scan``, ``pl.pallas_call`` at line 55).  The Hopper kernel
is ``csrc/rglru_scan.cu``; its plain version is ``ref.rglru_scan_ref``.  On
the serving path it is the prefill of every RG-LRU layer (recurrentgemma-9b:
B=2, T=4096, W=4096, f32).

What bounds it on the H100: bytes (a and b read once, h written once, 2
FLOP per 12 bytes).  The kernel gives one lane to each (batch, channel)
and walks T in order with h in a register, ``__fmul_rn`` then
``__fadd_rn``, so it equals the sequential plain version bit for bit; a
and b stream through a ring of shared-memory time chunks filled by
``cp.async``, so several chunks are in flight while the lanes walk one.

bf16: a and b in bfloat16 take the bf16 forward (entry point
``rglru_scan_bf16`` of the same source), as the TPU kernel runs it at bf16:
f32 state, each h_t rounded to bf16 at its store only, bitwise equal to the
plain version on the same inputs; bound by bytes (6 bytes an element).  The
reverse scan stays f32: the models scan in f32 (the reference's
``lm.py:339-340`` and ``recurrent.py:107``, the port's
``models/recurrent.py``), so no bf16 scan gradient is on any path.

Dispatch: a CPU tensor takes the plain version; a ``meta`` tensor (the
dry run's structs) computes nothing and returns empty tensors of the
outputs' shapes; a CUDA tensor launches the kernel of its dtype or raises.
Under ``roofline.analysis`` each call is one op, whatever the device, its
FLOPs and bytes ``roofline.kernels.rglru_scan_traffic``.
``launches`` counts the f32 kernel's launches and ``launches_bf16`` the
bf16 kernel's.

Training takes the gradient from ``rglru_scan_bwd``: the reverse scan
(entry point ``rglru_scan_bwd_f32`` of the same source), one lane per
(batch, channel) walking T backwards through the same ``cp.async`` ring,
bitwise equal to ``ref.rglru_scan_bwd_ref``; bound by bytes (a, h, dh read,
da and db written: 20 bytes an element).  ``bwd_launches`` counts it.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.roofline.analysis import kernel_op
from repro_torch.roofline.kernels import rglru_scan_traffic

# Launches of the CUDA kernels in this process (set them to 0 to start a
# count): the forward scan and the reverse scan.
launches = 0
bwd_launches = 0
launches_bf16 = 0


def _cost(a, backward=False):
    """A call's traffic, and no scratch (``roofline.analysis.kernel_op``)."""
    return rglru_scan_traffic(*a.shape, esize=a.element_size(),
                              backward=backward), 0


@kernel_op(lambda a, b: _cost(a))
def rglru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b: (B, T, W) -> h: (B, T, W), h_0 = 0."""
    if a.device.type == "meta":
        return torch.empty_like(a)
    if a.device.type == "cpu":
        return ref.rglru_scan_ref(a, b)
    return _launch(a, b)


@kernel_op(lambda a, h, dh: _cost(a, backward=True))
def rglru_scan_bwd(a: torch.Tensor, h: torch.Tensor, dh: torch.Tensor):
    """The scan's gradient: a, h (the forward's output), dh: (B, T, W) ->
    (da, db)."""
    if a.device.type == "meta":
        return torch.empty_like(a), torch.empty_like(a)
    if a.device.type == "cpu":
        return ref.rglru_scan_bwd_ref(a, h, dh)
    return _launch_bwd(a, h, dh)


def _check(what, named, dtypes=(torch.float32,)):
    """Contiguous (B, T, W) tensors of one shape and one of ``dtypes`` on
    one CUDA device."""
    dev = named[0][1].device
    dtype = named[0][1].dtype
    if dev.type != "cuda":
        raise ValueError(f"{what} kernel needs a CUDA tensor, got {dev}")
    if dtype not in dtypes:
        raise ValueError(f"{what} kernel takes {' or '.join(map(str, dtypes))}"
                         f", got {dtype}")
    for name, x in named:
        if x.dim() != 3 or x.dtype != dtype or x.device != dev \
                or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous (B, T, W) {dtype} "
                             f"tensor on {dev}, got {tuple(x.shape)} "
                             f"{x.dtype} on {x.device}")
        if x.shape != named[0][1].shape:
            raise ValueError(f"{named[0][0]} and {name} differ in shape: "
                             f"{tuple(named[0][1].shape)} vs "
                             f"{tuple(x.shape)}")
    if named[0][1].shape[0] > 65535:
        raise ValueError(f"B={named[0][1].shape[0]} must be <= 65535")
    return dev


def _launch(a, b):
    global launches, launches_bf16
    from repro_torch.kernels import build

    dev = _check("rglru_scan", (("a", a), ("b", b)),
                 (torch.float32, torch.bfloat16))
    bsz, t, w = a.shape
    out = torch.empty_like(a)
    if a.numel() == 0:
        return out
    bf16 = a.dtype == torch.bfloat16
    fn = build.library().rglru_scan_bf16 if bf16 \
        else build.library().rglru_scan_f32
    err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), bsz, t, w,
             dev.index or 0, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rglru_scan kernel launch failed: CUDA error {err}")
    if bf16:
        launches_bf16 += 1
    else:
        launches += 1
    return out


def _launch_bwd(a, h, dh):
    global bwd_launches
    from repro_torch.kernels import build

    dev = _check("rglru_scan_bwd", (("a", a), ("h", h), ("dh", dh)))
    bsz, t, w = a.shape
    da, db = torch.empty_like(a), torch.empty_like(a)
    if a.numel() == 0:
        return da, db
    err = build.library().rglru_scan_bwd_f32(
        a.data_ptr(), h.data_ptr(), dh.data_ptr(), da.data_ptr(),
        db.data_ptr(), bsz, t, w, dev.index or 0,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"rglru_scan_bwd kernel launch failed: CUDA error {err}")
    bwd_launches += 1
    return da, db
