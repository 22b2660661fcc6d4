"""ResNet-10/18/26/34 (BasicBlock) for the paper's measurement study
(counterpart of ``repro.models.resnet``).

GroupNorm instead of BatchNorm, a CIFAR-style 3x3 stem and no max-pool,
as in the reference.  Params keep the reference's nested shape and leaf
shapes: convolution weights stay HWIO, ``(kh, kw, c_in, c_out)``, so
``repro_torch.tree.leaves`` yields ``jax.tree.flatten``'s order and the
flat rows of the aggregators and the per-leaf int8 scales line up with the
reference element for element.  Images arrive NHWC, as the datasets give
them; the forward goes to NCHW once, at the stem, and each convolution
permutes its HWIO weight to a contiguous OIHW copy at the call.

Two things differ from a plain ``F.conv2d`` port and are pinned by
``tests/test_torch_resnet.py``:

  * XLA's ``SAME`` padding: ``total = max((ceil(in/s) - 1) * s + k - in,
    0)`` per spatial dimension, ``total // 2`` before and the rest after.
    A 3x3 stride-2 convolution on an even size pads 0 rows before and 1
    after, where ``padding=1`` would pad 1 on both sides and shift every
    output by a pixel.  Unequal pads are applied with ``F.pad``.
  * cuDNN's defaults: float32 convolutions in TF32 and a nondeterministic
    algorithm choice.  Every convolution, its backward included, runs
    under ``torch.backends.cudnn.flags(enabled=True, benchmark=False,
    deterministic=True, allow_tf32=False)`` (``_Conv2d``: autograd reads
    the flags when the backward runs, so the forward's guard alone would
    leave the gradients to the caller's setting).  On the CPU the guard is
    skipped: no CPU convolution reads those flags.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from repro_torch.configs.paper_models import ResNetConfig


def _cudnn_guard(x: torch.Tensor):
    if not x.is_cuda:
        return contextlib.nullcontext()
    return torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                      deterministic=True, allow_tf32=False)


class _Conv2d(torch.autograd.Function):
    """``F.conv2d`` with symmetric padding, forward and backward under
    ``_cudnn_guard``.  Batches under ``torch.func.vmap`` (the lanes of a
    packed cohort become a grouped convolution)."""
    generate_vmap_rule = True

    @staticmethod
    def forward(x, w, stride, padding):
        with _cudnn_guard(x):
            return F.conv2d(x, w, stride=stride, padding=padding)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, w, stride, padding = inputs
        ctx.save_for_backward(x, w)
        ctx.stride, ctx.padding = stride, padding

    @staticmethod
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        with _cudnn_guard(grad):
            gx, gw, _ = torch.ops.aten.convolution_backward(
                grad, x, w, None, list(ctx.stride), list(ctx.padding),
                [1, 1], False, [0, 0], 1,
                [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        return gx, gw, None, None


def same_pads(size: int, k: int, s: int):
    """XLA's ``SAME`` padding of one spatial dimension: (before, after)."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1):
    """x: (N, C, H, W); w: HWIO -> (N, O, ceil(H/s), ceil(W/s))."""
    top, bottom = same_pads(x.shape[-2], w.shape[0], stride)
    left, right = same_pads(x.shape[-1], w.shape[1], stride)
    if top != bottom or left != right:
        x = F.pad(x, (left, right, top, bottom))
        top = left = 0
    # a contiguous OIHW weight: the permuted view's strides read as
    # channels-last, which torch would then carry through the whole net
    return _Conv2d.apply(x, w.permute(3, 2, 0, 1).contiguous(),
                         (stride, stride), (top, left))


def _groupnorm(x, scale, bias, groups: int = 8, eps: float = 1e-5):
    """x: (N, C, H, W).  Statistics in f32 with the population variance,
    ``(x - mu) * rsqrt(var + eps)``, then scale and bias, cast back."""
    n, c, h, w = x.shape
    g = min(groups, c)
    while c % g:
        g -= 1
    xg = x.reshape(n, g, c // g, h, w).to(torch.float32)
    mu = xg.mean(dim=(2, 3, 4), keepdim=True)
    var = xg.var(dim=(2, 3, 4), keepdim=True, correction=0)
    xg = (xg - mu) * torch.rsqrt(var + eps)
    return (xg.reshape(n, c, h, w) * scale[:, None, None]
            + bias[:, None, None]).to(x.dtype)


def _conv_init(generator, shape, device, dtype):
    fan_in = shape[0] * shape[1] * shape[2]
    w = torch.randn(shape, generator=generator, dtype=torch.float32)
    return (w * math.sqrt(2.0 / fan_in)).to(device=device, dtype=dtype)


def _init_block(generator, c_in, c_out, device, dtype):
    def const(v):
        return torch.full((c_out,), v, dtype=dtype, device=device)
    p = {
        "conv1": _conv_init(generator, (3, 3, c_in, c_out), device, dtype),
        "gn1_s": const(1.0), "gn1_b": const(0.0),
        "conv2": _conv_init(generator, (3, 3, c_out, c_out), device, dtype),
        "gn2_s": const(1.0), "gn2_b": const(0.0),
    }
    if c_in != c_out:
        p["proj"] = _conv_init(generator, (1, 1, c_in, c_out), device, dtype)
    return p


def init_params(cfg: ResNetConfig, generator: torch.Generator,
                device: torch.device, dtype=torch.float32):
    """He-normal convolutions (``sqrt(2 / fan_in)``), unit GroupNorm scales,
    zero biases and a ``sqrt(1 / c)`` head, drawn on the CPU from
    ``generator`` and then moved to ``device``.  The reference's own init
    comes across with ``repro_torch.weights.params_from_numpy``."""
    widths = [cfg.width * (2 ** i) for i in range(4)]
    params = {
        "stem": _conv_init(generator, (3, 3, cfg.in_channels, widths[0]),
                           device, dtype),
        "stem_gn_s": torch.ones((widths[0],), dtype=dtype, device=device),
        "stem_gn_b": torch.zeros((widths[0],), dtype=dtype, device=device),
        "stages": [],
    }
    c_in = widths[0]
    for stage, n_blocks in enumerate(cfg.stage_blocks):
        c_out = widths[stage]
        blocks = []
        for _ in range(n_blocks):
            blocks.append(_init_block(generator, c_in, c_out, device, dtype))
            c_in = c_out
        params["stages"].append(blocks)
    head = torch.randn((c_in, cfg.n_classes), generator=generator,
                       dtype=torch.float32) * math.sqrt(1.0 / c_in)
    params["head_w"] = head.to(device=device, dtype=dtype)
    params["head_b"] = torch.zeros((cfg.n_classes,), dtype=dtype,
                                   device=device)
    return params


def _block_apply(p, x, stride: int):
    h = _conv(x, p["conv1"], stride)
    h = torch.relu(_groupnorm(h, p["gn1_s"], p["gn1_b"]))
    h = _conv(h, p["conv2"])
    h = _groupnorm(h, p["gn2_s"], p["gn2_b"])
    if "proj" in p:
        x = _conv(x, p["proj"], stride)
    elif stride != 1:
        x = x[:, :, ::stride, ::stride]
    return torch.relu(x + h)


def forward(params, cfg: ResNetConfig, images: torch.Tensor) -> torch.Tensor:
    """images: (B, H, W, C) -> logits (B, n_classes)."""
    # a fresh NCHW tensor: with C = 1 the permuted view already counts as
    # contiguous, and its strides would read as channels-last
    x = images.permute(0, 3, 1, 2).clone(memory_format=torch.contiguous_format)
    x = _conv(x, params["stem"])
    x = torch.relu(_groupnorm(x, params["stem_gn_s"], params["stem_gn_b"]))
    for stage, blocks in enumerate(params["stages"]):
        for b, p in enumerate(blocks):
            stride = 2 if (stage > 0 and b == 0) else 1
            x = _block_apply(p, x, stride)
    x = x.mean(dim=(2, 3))
    return x @ params["head_w"] + params["head_b"]


def flops_per_example(cfg: ResNetConfig) -> float:
    """Analytic forward FLOPs for one input (multiply-adds x2)."""
    hw = cfg.image_size ** 2
    widths = [cfg.width * (2 ** i) for i in range(4)]
    total = 2 * 9 * cfg.in_channels * widths[0] * hw
    c_in = widths[0]
    res = hw
    for stage, n_blocks in enumerate(cfg.stage_blocks):
        c_out = widths[stage]
        for b in range(n_blocks):
            stride = 2 if (stage > 0 and b == 0) else 1
            res = res // (stride * stride)
            total += 2 * 9 * c_in * c_out * res
            total += 2 * 9 * c_out * c_out * res
            if c_in != c_out:
                total += 2 * c_in * c_out * res
            c_in = c_out
    total += 2 * c_in * cfg.n_classes
    return float(total)
