"""Shared primitives: norms, initializers, RoPE, soft-cap, activations.

Port of ``repro.models.common``.  The initializers draw from an explicit
``torch.Generator`` on the target device (``jax.random`` cannot be
reproduced).  The sharding shortcuts at the end constrain an activation to
its logical layout on a device mesh (``repro_torch.sharding``); on one
device, or on a plain tensor, they return their argument.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.sharding.ctx import logical_constraint


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

class MetaGenerator:
    """Stands in for a ``torch.Generator`` in the init functions to build a
    param tree on the ``meta`` device: shapes and dtypes, nothing allocated
    or drawn (``launch.steps.param_struct``)."""
    device = torch.device("meta")


def _normal(gen, shape) -> torch.Tensor:
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=torch.float32, device="meta")
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=torch.float32)


def dense_init(gen: torch.Generator, shape, dtype=torch.float32,
               fan_in: Optional[int] = None) -> torch.Tensor:
    """Normal(0, 1/fan_in) on ``gen``'s device; fan_in defaults to
    ``shape[-2]`` (``shape[0]`` for a vector)."""
    if fan_in is None:
        fan_in = shape[-2] if len(shape) >= 2 else shape[0]
    x = _normal(gen, shape)
    return x.mul_(math.sqrt(1.0 / max(fan_in, 1))).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype=torch.float32
               ) -> torch.Tensor:
    return _normal(gen, shape).mul_(0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms / activations
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    dtype = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + weight.to(torch.float32))).to(dtype)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) with no threshold (``F.softplus``
    returns x itself above 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation (PyTorch's default
    is the exact erf form)."""
    return F.gelu(x, approximate="tanh")


def activation(name: str):
    return {"silu": F.silu, "gelu": gelu, "relu": F.relu}[name]


def causal_conv(x: torch.Tensor, conv_w: torch.Tensor,
                conv_b: torch.Tensor) -> torch.Tensor:
    """x: (B,S,W); width-cw causal depthwise conv via shifted adds (the
    reference's ``_causal_conv`` of the recurrent and xLSTM blocks)."""
    cw = conv_w.shape[0]
    out = torch.zeros_like(x)
    for i in range(cw):
        shifted = x if i == 0 else torch.cat(
            [torch.zeros_like(x[:, :i]), x[:, :-i]], dim=1)
        out = out + shifted * conv_w[cw - 1 - i]
    return out + conv_b


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S).  Half-split
    rotation (first and second halves of D), not interleaved pairs."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                   # (D/2,)
    angles = positions[..., None].to(torch.float32) * freqs  # (..., S, D/2)
    angles = angles[..., None, :]                            # (..., S, 1, D/2)
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# logical sharding shortcuts for common activation layouts
# ---------------------------------------------------------------------------

def shard_bse(x):   # (batch, seq, embed)
    return logical_constraint(x, ("batch", "seq", "embed"))


def shard_bshd(x):  # (batch, seq, heads, head_dim)
    return logical_constraint(x, ("batch", None, "heads", None))

