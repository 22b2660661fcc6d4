"""The kernel entry points the rest of the port calls (``repro.kernels.ops``'
counterpart).  Each dispatches on its tensor's device: the plain PyTorch
version on the CPU, the hand-written Hopper kernel on CUDA.

``flash_attention`` and ``rglru_scan`` are differentiable.  Where autograd
records (grad enabled and an input that requires grad) they run as
``torch.autograd.Function``s whose backward is the kernel's own backward:
``flash_attention_bwd`` from the saved (q, k, v, out, lse), and the reverse
scan ``rglru_scan_bwd`` from the saved (a, h).  A CUDA tensor runs the
kernels both ways and a CPU tensor the plain versions both ways; a kernel
that fails to build or launch raises, nothing falls back.  Elsewhere
(serving, ``no_grad``) they call the forward alone, exactly as before: no
lse is written.

Both Functions keep the inputs' dtype: at bf16 the forward returns bf16
(lse stays f32) and the backward bf16 gradients (``RGLRUScanFn``'s reverse
scan is f32 only: the models scan in f32).
"""

from typing import Optional

import torch

from repro_torch.kernels import flash_attention as _fl
from repro_torch.kernels import rglru_scan as _sc
from repro_torch.kernels.fed_aggregate import fed_aggregate  # noqa: F401
from repro_torch.kernels.fed_reduce import fed_reduce  # noqa: F401


def _records(*xs) -> bool:
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


class FlashAttentionFn(torch.autograd.Function):
    """``flash_attention`` with its backward kernel; saves (q, k, v, out,
    lse) of the forward that made ``out``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, cap):
        out, lse = _fl.flash_attention(q, k, v, causal=causal, window=window,
                                       cap=cap, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = (causal, window, cap)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, cap = ctx.opts
        per16 = 16 // dout.element_size()
        if dout.stride(-1) != 1 \
                or any(st % per16 for st in dout.stride()[:3]) \
                or dout.data_ptr() % 16:
            dout = dout.contiguous()      # the kernel reads 16-byte rows
        dq, dk, dv = _fl.flash_attention_bwd(q, k, v, out, lse, dout,
                                             causal=causal, window=window,
                                             cap=cap)
        return dq, dk, dv, None, None, None


class RGLRUScanFn(torch.autograd.Function):
    """``rglru_scan`` with its reverse-scan backward; saves (a, h)."""

    @staticmethod
    def forward(ctx, a, b):
        h = _sc.rglru_scan(a, b)
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, dh):
        a, h = ctx.saved_tensors
        return _sc.rglru_scan_bwd(a, h, dh.contiguous())


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    cap: Optional[float] = None) -> torch.Tensor:
    """q: (B, H, S, D); k, v: (B, Kh, T, D) -> (B, H, S, D)."""
    if _records(q, k, v):
        return FlashAttentionFn.apply(q, k, v, causal, window, cap)
    return _fl.flash_attention(q, k, v, causal=causal, window=window,
                               cap=cap)


def rglru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b: (B, T, W) -> h: (B, T, W), h_0 = 0."""
    if _records(a, b):
        return RGLRUScanFn.apply(a, b)
    return _sc.rglru_scan(a, b)
