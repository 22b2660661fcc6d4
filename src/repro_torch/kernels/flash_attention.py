"""flash_attention: causal / sliding-window GQA attention with a tanh soft-cap.

Replaces the Pallas TPU kernel ``src/repro/kernels/flash_attention.py::
_kernel`` (wrapper ``flash_attention``, ``pl.pallas_call`` at line 113).
The Hopper kernel is ``csrc/flash_attention.cu``; its plain version is
``ref.flash_attention_ref``.  On the serving path it is every
full-sequence attention of a prefill: recurrentgemma-9b's local layers
(B=2, H=16, Kh=1, S=T=4096, D=256, window 2048), granite-moe's (G=2,
D=64), dbrx's (G=6, D=128), internvl2's over the vision prefix and the
prompt (G=7, D=64), seamless-m4t's non-causal encoder and its decoder's
self- and cross-attention (S=512 queries over T=1024 frames); f32.

What bounds it on the H100: operations (206 GFLOP against 0.29 GB at
that shape).  Both products run on the tensor cores (``wgmma`` with TF32
operands) as three passes over split operands, x = tf32(x) +
tf32(x - tf32(x)), which keeps f32 accuracy (one TF32 pass would not hold
2e-5).  A split pass first writes K and V once as 16-key tiles of TF32
operand planes into a scratch buffer this wrapper allocates (twice K's and
V's bytes); the attention kernel then streams those tiles through a
two-stage ring of bulk copies.  A block owns 64
(position, group head) rows of one kv head, so one K/V tile serves every
head of the group and no repeated K/V is ever made; kv tiles outside the
causal frontier or the window are skipped; the online softmax keeps m, l,
the probabilities and the output rows in registers.

Layout: q (B, H, S, D), k and v (B, Kh, T, D), ``H % Kh == 0``, as the TPU
wrapper.  The kernel reads every tensor through its strides (the head dim
must be contiguous), so a (B, S, H, D) tensor viewed as (B, H, S, D) costs
no copy, and the output is allocated with q's strides.  Query i sits at key
position ``i + (T - S)``, as in the reference; any S and T work, except
causal S > T (rows with no key), which raises.

bf16: q, k and v in bfloat16 take the bf16 kernels
(``csrc/flash_attention_bf16.cu`` and ``csrc/flash_attention_bwd_bf16.cu``),
which compute what the TPU kernel computes at bf16: f32 arithmetic on the
bf16 inputs, the output (or dq, dk, dv) rounded once to bf16, lse in f32.
Q K^T is one bf16 ``wgmma`` (exact products), P V two (P split into bf16
hi and lo); the backward rounds P and dS to bf16 once.  What bounds them is
operations at the bf16 tensor-core rate (989 TFLOP/s).  In both, one
producer thread keeps copies in flight into a ring of shared-memory slots
on mbarriers and two warpgroups compute.  The forward is one launch: TMA
brings K and V tiles straight from k and v (tensor maps built per call)
and the two warpgroups take turns on the tensor cores, one's softmax
running while the other's products run.
The backward is two launches: a prep pass lays Q/dO row tiles (with each
row's lse and delta) and K/V key tiles out in scratch this wrapper
allocates (``flash_attention_bwd_plan_bf16`` sizes it), then one launch of
kv-major (dK, dV) and q-major (dQ, recomputing the scores) blocks, longest
walks first, streams the tiles by bulk copies.  Its gradient sums stay in
the tensor cores over the whole walk, and it is deterministic (no
atomics).  q, k and v share one dtype, float32 or bfloat16; fp16 and mixed
dtypes raise ``ValueError``.  Rows are 16-byte aligned: 4 f32 or 8 bf16
values.

Dispatch: a CPU tensor takes the plain version, its results laid out as
the kernel lays them out (q's strides, and k's and v's for their
gradients); a ``meta`` tensor (the dry run's structs) computes nothing and
returns empty tensors of those shapes; a CUDA tensor launches the kernel
of its dtype (f32: the split pass and the attention kernel, one entry
point) or raises.  ``launches`` counts the f32 kernel's launches and
``launches_bf16`` the bf16 kernel's, one a call.  Under
``roofline.analysis`` each call is one op, whatever the device: its
FLOPs and bytes are ``roofline.kernels.attention_traffic`` (the bounds'
count) and it allocates its outputs and the kernel's scratch.

Training (``ops.flash_attention`` under autograd) asks the forward for the
rows' log-sum-exp as well (``return_lse``; serving passes a null pointer and
its launches do not change) and takes the gradient from
``flash_attention_bwd``: the Hopper kernel ``csrc/flash_attention_bwd.cu``
(plain version ``ref.flash_attention_bwd_ref``), counted in
``bwd_launches``.  What bounds it is operations too (10 D flops a live
pair: 2.08 ms as 3xTF32 at gemma2-2b's global layer).  Its products run as
``wgmma`` 3xTF32: a prep pass splits K and V once per call into operand
planes and lays Q and dO out in 64-row tiles (with each row's lse and
delta) in a scratch buffer this wrapper allocates; kv-major blocks (dK, dV)
and q-major blocks (dQ, recomputing the scores) run in one launch, longest
walks first, each streaming the other side's tiles through a ring of bulk
copies.  It is deterministic (no atomics; tensor-core sums kept to one step
and added in f32) and skips the tiles the mask leaves out.  The bf16
backward is counted in ``bwd_launches_bf16``, one a call (two device
kernels).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ref
from repro_torch.roofline.analysis import kernel_op
from repro_torch.roofline.kernels import (attention_scratch_bytes,
                                          attention_traffic)

HEAD_DIMS = (32, 64, 128, 256)
DTYPES = (torch.float32, torch.bfloat16)

# Launches of the CUDA kernels in this process (set them to 0 to start a
# count): the forward and the backward, f32 and bf16.
launches = 0
bwd_launches = 0
launches_bf16 = 0
bwd_launches_bf16 = 0


def _cost(q, k, backward, causal, window, lse=False):
    """A call's traffic and scratch (``roofline.analysis.kernel_op``)."""
    b, h, s, d = q.shape
    kh, t = k.shape[1], k.shape[2]
    esize = q.element_size()
    return (attention_traffic(b, h, kh, s, t, d, causal=causal,
                              window=window, esize=esize, backward=backward,
                              lse=lse),
            attention_scratch_bytes(b, h, kh, s, t, d, esize=esize,
                                    backward=backward))


def _fwd_cost(q, k, v, *, causal=True, window=None, cap=None,
              return_lse=False):
    return _cost(q, k, False, causal, window, return_lse)


def _bwd_cost(q, k, v, out, lse, dout, *, causal=True, window=None,
              cap=None):
    return _cost(q, k, True, causal, window)


def _like(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``x`` in ``like``'s layout (``empty_like``'s, as the kernels write)."""
    if x.stride() == like.stride():
        return x
    return torch.empty_like(like).copy_(x)


@kernel_op(_fwd_cost)
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    cap: Optional[float] = None, return_lse: bool = False):
    """q: (B, H, S, D); k, v: (B, Kh, T, D), H % Kh == 0 -> (B, H, S, D),
    and with ``return_lse`` also the rows' log-sum-exp (B, H, S) f32."""
    if q.device.type == "meta":
        out = torch.empty_like(q)
        lse = torch.empty(q.shape[:3], dtype=torch.float32, device="meta")
        return (out, lse) if return_lse else out
    if q.device.type == "cpu":
        got = ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                      cap=cap, return_lse=return_lse)
        if return_lse:
            return _like(got[0], q), got[1]
        return _like(got, q)
    return _launch(q, k, v, causal, window, cap, return_lse)


@kernel_op(_bwd_cost)
def flash_attention_bwd(q, k, v, out, lse, dout, *, causal: bool = True,
                        window: Optional[int] = None,
                        cap: Optional[float] = None):
    """The gradient (dq, dk, dv) of ``flash_attention`` from its output
    ``out``, its ``lse`` (B, H, S) and the output's gradient ``dout``."""
    if q.device.type == "meta":
        return tuple(torch.empty_like(x) for x in (q, k, v))
    if q.device.type == "cpu":
        got = ref.flash_attention_bwd_ref(q, k, v, out, lse, dout,
                                          causal=causal, window=window,
                                          cap=cap)
        return tuple(_like(g, x) for g, x in zip(got, (q, k, v)))
    return _launch_bwd(q, k, v, out, lse, dout, causal, window, cap)


def _check_rows(dev, named):
    """Each tensor: 4-d on ``dev``, all of one dtype (float32 or bfloat16),
    head dim contiguous, rows 16-byte aligned (what the kernels read
    through their strides)."""
    dtype = named[0][1].dtype
    if dtype not in DTYPES:
        raise ValueError(f"{named[0][0]}: the kernels take float32 or "
                         f"bfloat16, got {dtype}")
    per16 = 16 // named[0][1].element_size()
    for name, x in named:
        if x.dim() != 4 or x.device != dev:
            raise ValueError(f"{name} must be a 4-d tensor on {dev}, got "
                             f"{tuple(x.shape)} on {x.device}")
        if x.dtype != dtype:
            raise ValueError(f"{name} is {x.dtype} where {named[0][0]} is "
                             f"{dtype}: the kernels take one dtype")
        if x.stride(3) != 1 or any(s % per16 for s in x.stride()[:3]) \
                or x.data_ptr() % 16:
            raise ValueError(f"{name}: the head dim must be contiguous and "
                             "every row 16-byte aligned")


def _check_shapes(q, k, v, causal, window, cap):
    b, h, s, d = q.shape
    kh, t = k.shape[1], k.shape[2]
    if k.shape != (b, kh, t, d) or v.shape != k.shape:
        raise ValueError(f"k and v must be ({b}, Kh, T, {d}), got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if kh == 0 or h % kh:
        raise ValueError(f"H={h} is not a multiple of Kh={kh}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported (one of {HEAD_DIMS})")
    if causal and s > t:
        raise ValueError(f"causal attention with S={s} > T={t} leaves "
                         "queries with no key")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if cap is not None and not cap > 0:
        raise ValueError(f"cap must be > 0, got {cap}")
    if b > 65535 or kh > 65535:
        raise ValueError(f"B={b} and Kh={kh} must be <= 65535")


def _cuda_device(q, what):
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"{what} kernel needs a CUDA tensor, got {dev}")
    return dev


def _launch(q, k, v, causal, window, cap, return_lse=False):
    global launches, launches_bf16
    from repro_torch.kernels import build

    dev = _cuda_device(q, "flash_attention")
    _check_rows(dev, (("q", q), ("k", k), ("v", v)))
    _check_shapes(q, k, v, causal, window, cap)
    b, h, s, d = q.shape
    kh, t = k.shape[1], k.shape[2]
    out = torch.empty_like(q)           # q's layout where q is dense
    lse = torch.empty((b, h, s), dtype=torch.float32, device=dev) \
        if return_lse else None
    if q.numel() == 0:
        return (out, lse) if return_lse else out
    if q.dtype == torch.bfloat16:
        err = build.library().flash_attention_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3], b, h, kh, s, t, d, int(causal),
            0 if window is None else int(window), float(d ** -0.5),
            0.0 if cap is None else float(cap),
            dev.index or 0, torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError("flash_attention bf16 kernel launch failed: "
                               f"CUDA error {err}")
        launches_bf16 += 1
        return (out, lse) if return_lse else out
    # scratch for the kernel's split pass: K and V in 16-key tiles of four
    # TF32 operand planes (hi and lo of K and of V transposed)
    planes = torch.empty(b * kh * -(-t // 16) * 64 * d, dtype=torch.float32,
                         device=dev)
    err = build.library().flash_attention_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        planes.data_ptr(), None if lse is None else lse.data_ptr(),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *out.stride()[:3], b, h, kh, s, t, d, int(causal),
        0 if window is None else int(window), float(d ** -0.5),
        0.0 if cap is None else float(cap),
        dev.index or 0, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"flash_attention kernel launch failed: CUDA error {err}")
    launches += 1
    return (out, lse) if return_lse else out


def _launch_bwd(q, k, v, out, lse, dout, causal, window, cap):
    global bwd_launches
    import ctypes

    from repro_torch.kernels import build

    dev = _cuda_device(q, "flash_attention_bwd")
    _check_rows(dev, (("q", q), ("k", k), ("v", v), ("out", out),
                      ("dout", dout)))
    _check_shapes(q, k, v, causal, window, cap)
    b, h, s, d = q.shape
    kh, t = k.shape[1], k.shape[2]
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"out and dout must be {tuple(q.shape)}, got "
                         f"{tuple(out.shape)} and {tuple(dout.shape)}")
    if lse.shape != (b, h, s) or lse.dtype != torch.float32 \
            or lse.device != dev or not lse.is_contiguous():
        raise ValueError(f"lse must be a contiguous ({b}, {h}, {s}) float32 "
                         f"tensor on {dev}, got {tuple(lse.shape)} "
                         f"{lse.dtype} on {lse.device}")
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    if q.numel() == 0:
        return dq, dk, dv
    lib = build.library()
    if q.dtype == torch.bfloat16:
        return _launch_bwd_bf16(lib, q, k, v, out, lse, dout, dq, dk, dv,
                                causal, window, cap)
    # scratch for the prep pass: split K/V planes and Q/dO row tiles
    info = (ctypes.c_longlong * 5)()
    nbytes = lib.flash_attention_bwd_plan_f32(
        b, h, kh, s, t, d, 0 if window is None else int(window), info)
    if nbytes < 0:
        raise ValueError(f"flash_attention_bwd refuses the shape "
                         f"{tuple(q.shape)} / {tuple(k.shape)}")
    work = torch.empty(nbytes // 4, dtype=torch.float32, device=dev)
    strides = (ctypes.c_longlong * 24)(*(
        st for x in (q, k, v, out, dout, dq, dk, dv) for st in x.stride()[:3]))
    err = lib.flash_attention_bwd_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), work.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), strides, b, h, kh, s, t, d,
        int(causal), 0 if window is None else int(window), float(d ** -0.5),
        0.0 if cap is None else float(cap),
        dev.index or 0, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"flash_attention_bwd kernel launch failed: CUDA error {err}")
    bwd_launches += 1
    return dq, dk, dv


def _launch_bwd_bf16(lib, q, k, v, out, lse, dout, dq, dk, dv, causal,
                     window, cap):
    global bwd_launches_bf16
    import ctypes

    dev = q.device
    b, h, s, d = q.shape
    kh, t = k.shape[1], k.shape[2]
    w = 0 if window is None else int(window)
    # scratch for the prep pass: Q/dO row tiles and K/V key tiles
    info = (ctypes.c_longlong * 5)()
    nbytes = lib.flash_attention_bwd_plan_bf16(b, h, kh, s, t, d, w, info)
    if nbytes < 0:
        raise ValueError(f"flash_attention_bwd refuses the shape "
                         f"{tuple(q.shape)} / {tuple(k.shape)}")
    work = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    strides = (ctypes.c_longlong * 24)(*(
        st for x in (q, k, v, out, dout, dq, dk, dv) for st in x.stride()[:3]))
    err = lib.flash_attention_bwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), work.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), strides, b, h, kh, s, t, d,
        int(causal), w, float(d ** -0.5), 0.0 if cap is None else float(cap),
        dev.index or 0, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("flash_attention_bwd bf16 kernel launch failed: "
                           f"CUDA error {err}")
    bwd_launches_bf16 += 1
    return dq, dk, dv
