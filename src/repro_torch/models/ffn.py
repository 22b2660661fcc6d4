"""Feed-forward layers: the dense gated MLP (SwiGLU / GeGLU).

Port of ``repro.models.ffn``'s dense MLP (``init_mlp_params``, ``mlp``).
The top-k mixture of experts waits for its slice (see ROADMAP.md).
"""

from __future__ import annotations

import torch

from repro_torch.models.common import activation, dense_init


def init_mlp_params(gen: torch.Generator, d_model: int, d_ff: int,
                    dtype=torch.float32):
    return {
        "w_gate": dense_init(gen, (d_model, d_ff), dtype),
        "w_up": dense_init(gen, (d_model, d_ff), dtype),
        "w_down": dense_init(gen, (d_ff, d_model), dtype),
    }


def mlp(params, x: torch.Tensor, act_name: str = "silu") -> torch.Tensor:
    act = activation(act_name)
    h = act(x @ params["w_gate"])
    h = h * (x @ params["w_up"])
    return h @ params["w_down"]
