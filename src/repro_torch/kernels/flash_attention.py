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
causal S > T (rows with no key), which raises.  f32 only: other dtypes
raise ``ValueError``.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel (the split pass and the attention kernel, one entry point) or
raises.  ``launches`` counts the kernel's launches, one a call.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ref

HEAD_DIMS = (32, 64, 128, 256)

# Launches of the CUDA kernel in this process (set it to 0 to start a count).
launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    cap: Optional[float] = None) -> torch.Tensor:
    """q: (B, H, S, D); k, v: (B, Kh, T, D), H % Kh == 0 -> (B, H, S, D)."""
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       cap=cap)
    return _launch(q, k, v, causal, window, cap)


def _launch(q, k, v, causal, window, cap):
    global launches
    from repro_torch.kernels import build

    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_attention kernel needs a CUDA tensor, got "
                         f"{dev}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dim() != 4 or x.device != dev:
            raise ValueError(f"{name} must be a 4-d tensor on {dev}, got "
                             f"{tuple(x.shape)} on {x.device}")
        if x.dtype != torch.float32:
            raise ValueError(f"{name}: the kernel takes float32 only, got "
                             f"{x.dtype}")
        if x.stride(3) != 1 or any(s % 4 for s in x.stride()[:3]) \
                or x.data_ptr() % 16:
            raise ValueError(f"{name}: the head dim must be contiguous and "
                             "every row 16-byte aligned")
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
    out = torch.empty_like(q)           # q's layout where q is dense
    if q.numel() == 0:
        return out
    # scratch for the kernel's split pass: K and V in 16-key tiles of four
    # TF32 operand planes (hi and lo of K and of V transposed)
    planes = torch.empty(b * kh * -(-t // 16) * 64 * d, dtype=torch.float32,
                         device=dev)
    err = build.library().flash_attention_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        planes.data_ptr(),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *out.stride()[:3], b, h, kh, s, t, d, int(causal),
        0 if window is None else int(window), float(d ** -0.5),
        0.0 if cap is None else float(cap),
        dev.index or 0, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"flash_attention kernel launch failed: CUDA error {err}")
    launches += 1
    return out
