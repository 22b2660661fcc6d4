"""RecurrentGemma / Griffin recurrent block: causal conv1d + RG-LRU.

Port of ``repro.models.recurrent``.  The RG-LRU recurrence
h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t) is a diagonal linear
recurrence; the full-sequence pass runs it through ``ops.rglru_scan`` (the
sequential plain version on the CPU, the Hopper kernel on CUDA), where the
reference uses ``jax.lax.associative_scan``; under autograd its backward is
the reverse scan (plain on the CPU, the kernel on CUDA), where the reference
differentiates the associative scan.  Decode carries (h, conv tail).

On a device mesh the conv input is constrained to ("batch", None, "ff") as
in the reference, and the scan runs on each rank's local shard through
``local_map``: its batch shard and its ``ff`` channels.  The recurrence is
channel-wise, so a channel shard is exact.

As in the reference, the recurrence and input gates use per-channel
(diagonal) weights rather than Griffin's block-diagonal maps.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.common import causal_conv, dense_init, gelu, softplus
from repro_torch.sharding.ctx import (PartitionSpec as P, current_mesh,
                                      current_rules, is_dtensor,
                                      logical_constraint, to_placements)

_C = 8.0  # Griffin's recurrence sharpness constant


def init_rglru_params(gen: torch.Generator, cfg: ModelConfig,
                      dtype=torch.float32):
    d = cfg.d_model
    w = cfg.lru_width or d
    cw = cfg.conv1d_width
    dev = gen.device
    zeros = lambda: torch.zeros((w,), dtype=dtype, device=dev)  # noqa: E731
    # Lambda init so that a = sigmoid(lambda) in [0.9, 0.999]
    lin = torch.linspace(0.9, 0.999, w, dtype=torch.float32, device=dev)
    lam = torch.log(torch.expm1(lin) / (1 - lin))
    return {
        "w_in": dense_init(gen, (d, w), dtype),
        "w_gate_branch": dense_init(gen, (d, w), dtype),
        "conv_w": dense_init(gen, (cw, w), dtype, fan_in=cw),
        "conv_b": zeros(),
        # RG-LRU gates (diagonal) + Lambda
        "a_gate_w": zeros(),
        "a_gate_b": zeros(),
        "x_gate_w": zeros(),
        "x_gate_b": zeros(),
        "lam": lam.to(dtype),
        "w_out": dense_init(gen, (w, d), dtype, fan_in=w),
    }


def _gates(params, u: torch.Tensor):
    """u: conv output (..., W). Returns (a, beta*i*u) recurrence coeffs."""
    r = torch.sigmoid(u * params["a_gate_w"] + params["a_gate_b"])
    i = torch.sigmoid(u * params["x_gate_w"] + params["x_gate_b"])
    log_a = -_C * softplus(params["lam"]) * r
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12))
    return a, beta * i * u


def rglru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Diagonal linear recurrence h_t = a_t h_{t-1} + b_t over axis 1, from
    h_0 = 0.  a, b: (B, S, W) f32; on a mesh, DTensors scanned shard by
    shard (batch and channels)."""
    mesh = current_mesh()
    if mesh is not None and is_dtensor(a):
        from repro_torch.sharding.specs import fit_spec
        from torch.distributed.tensor.experimental import local_map
        rules = current_rules()
        pl = to_placements(fit_spec(P(rules.get("batch"), None,
                                      rules.get("ff")), a.shape, mesh), mesh)
        return local_map(lambda al, bl: ops.rglru_scan(al.contiguous(),
                                                       bl.contiguous()),
                         out_placements=list(pl), in_placements=(pl, pl),
                         device_mesh=mesh, redistribute_inputs=True)(a, b)
    return ops.rglru_scan(a.contiguous(), b.contiguous())


class RGLRUState(NamedTuple):
    h: torch.Tensor          # (B, W) recurrent state
    conv_tail: torch.Tensor  # (B, cw-1, W) last conv inputs


def init_rglru_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
                     device=None) -> RGLRUState:
    w = cfg.lru_width or cfg.d_model
    return RGLRUState(
        h=torch.zeros((batch, w), dtype=dtype, device=device),
        conv_tail=torch.zeros((batch, cfg.conv1d_width - 1, w), dtype=dtype,
                              device=device),
    )


def rglru_sequence(params, x: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-sequence block that also returns what decode carries on:
    (y (B,S,d), the last hidden state h (B,W), the conv input u (B,S,W)).
    One scan: the reference's prefill scans a second time for h, on the
    same inputs, so the port takes h from this one, as a copy of its own
    (a view would keep the whole (B,S,W) scan output alive)."""
    gate = gelu(x @ params["w_gate_branch"])
    u = x @ params["w_in"]
    u = logical_constraint(u, ("batch", None, "ff"))
    uc = causal_conv(u, params["conv_w"], params["conv_b"])
    a, b = _gates(params, uc)
    h = rglru_scan(a.to(torch.float32), b.to(torch.float32))
    y = (h.to(x.dtype) * gate) @ params["w_out"]
    return y, h[:, -1].clone(), u


def rglru_block(params, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence Griffin recurrent block. x: (B,S,d) -> (B,S,d)."""
    return rglru_sequence(params, x)[0]


def rglru_decode_step(params, x: torch.Tensor, state: RGLRUState):
    """One-token decode. x: (B,1,d)."""
    gate = gelu(x @ params["w_gate_branch"])
    u = x @ params["w_in"]                                      # (B,1,W)
    conv_in = torch.cat([state.conv_tail, u], dim=1)            # (B,cw,W)
    cw = params["conv_w"].shape[0]
    u_c = torch.einsum("bcw,cw->bw", conv_in[:, -cw:], params["conv_w"])
    u_c = (u_c + params["conv_b"])[:, None]                     # (B,1,W)
    a, b = _gates(params, u_c)
    h_new = a[:, 0] * state.h + b[:, 0]
    out = h_new[:, None].to(x.dtype) * gate
    y = out @ params["w_out"]
    return y, RGLRUState(h=h_new, conv_tail=conv_in[:, 1:])
