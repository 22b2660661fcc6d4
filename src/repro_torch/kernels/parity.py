"""How a kernel's result is held against its plain version.

``rel_err`` is the whole-tensor measure, max |got - want| over max |want|.
At bf16 it is too coarse for attention: the largest value of a causal
output sits in the first rows (row 0's output is v[0]), so a limit on it is
as large as a typical value of the rows that see thousands of keys.  The
bf16 kernels are therefore also held element by element (``bf16_ulps``,
with a floor per row, ``row_floor``) and row by row (``row_rel_err``).
"""

import torch

TINY = 1.1754943508222875e-38      # the smallest normal f32
# the bf16 attention's element limit: 2 bf16 ulps plus this share of the
# row's max-abs, which covers the f32 sums' differing order before the one
# rounding (a kernel-like emulation needs under 1 ulp at 1e-4)
BF16_ROW_FLOOR = 1e-3


def _pair(got, want):
    """``got`` and ``want`` on ``want``'s device, in f64 if either is f64,
    else f32."""
    dt = torch.float64 if torch.float64 in (got.dtype, want.dtype) \
        else torch.float32
    return got.detach().to(want.device, dt), want.detach().to(dt)


def rel_err(got, want) -> float:
    """max |got - want| over max |want| (0.0 where they are equal)."""
    g, w = _pair(got, want)
    if w.numel() == 0:
        return 0.0
    num = float((g - w).abs().max())
    return 0.0 if num == 0.0 else num / max(float(w.abs().max()), 1e-30)


def row_rel_err(got, want, share: float = 1e-3) -> float:
    """The largest over rows (all axes but the last) of max |got - want|
    over the row's max |want|, or over ``share`` of the whole tensor's max
    |want| where that is larger: a row that is zero by cancellation (row 0
    of a causal dq, whose output is v[0] itself) carries only the rounding
    of that cancellation."""
    g, w = _pair(got, want)
    if w.numel() == 0:
        return 0.0
    num = (g - w).abs().amax(-1)
    den = w.abs().amax(-1).clamp_min(share * float(w.abs().max()))
    err = torch.where(num == 0, torch.zeros_like(num),
                      num / den.clamp_min(1e-30))
    return float(err.max())


def row_floor(want, share: float):
    """``share`` of each row's max |want| (all axes but the last), shaped
    to broadcast against ``want``: the absolute slack a row's f32 sums may
    differ by before the one rounding to bf16."""
    return want.detach().abs().amax(-1, keepdim=True).double() * share


def bf16_ulps(got, want, slack=0.0) -> float:
    """The largest |got - want| beyond ``slack`` (a number, or a tensor
    that broadcasts against ``want``), in bf16 ulps at |want|; in f64."""
    g = got.detach().to(want.device, torch.float64)
    w = want.detach().to(torch.float64)
    if w.numel() == 0:
        return 0.0
    ulp = (w.abs().clamp_min(TINY).log2().floor() - 7).exp2()
    if isinstance(slack, torch.Tensor):
        slack = slack.to(w.device, torch.float64)
    return float(((g - w).abs() - slack).clamp_min(0.0).div(ulp).max())
