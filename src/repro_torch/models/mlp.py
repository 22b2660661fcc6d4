"""The paper's EMNIST model: an MLP with one hidden layer (200 ReLU units).

Counterpart of ``repro.models.mlp``.  Parameters keep the reference's
nested shape ``{"layers": [{"w": (d_in, d_out), "b": (d_out,)}, ...]}``.
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.paper_models import MLPConfig


def init_params(cfg: MLPConfig, generator: torch.Generator,
                device: torch.device, dtype=torch.float32):
    """He-normal weights and zero biases, drawn on the CPU from
    ``generator`` and then moved to ``device`` (so a seed gives the same
    params on every device).  A ``torch.Generator`` cannot reproduce
    ``jax.random``: to start from the reference's params, carry them across
    with ``repro_torch.weights.params_from_numpy``."""
    dims = (cfg.in_dim,) + tuple(cfg.hidden) + (cfg.n_classes,)
    layers = []
    for i in range(len(dims) - 1):
        w = torch.randn((dims[i], dims[i + 1]), generator=generator,
                        dtype=torch.float32) * math.sqrt(2.0 / dims[i])
        layers.append({"w": w.to(device=device, dtype=dtype),
                       "b": torch.zeros((dims[i + 1],), dtype=dtype,
                                        device=device)})
    return {"layers": layers}


def forward(params, cfg: MLPConfig, x: torch.Tensor) -> torch.Tensor:
    """x: (B, in_dim) or (B, H, W[, C]) flattened."""
    x = x.reshape(x.shape[0], -1)
    layers = params["layers"]
    for p in layers[:-1]:
        x = torch.relu(x @ p["w"] + p["b"])
    p = layers[-1]
    return x @ p["w"] + p["b"]


def flops_per_example(cfg: MLPConfig) -> float:
    dims = (cfg.in_dim,) + tuple(cfg.hidden) + (cfg.n_classes,)
    return float(sum(2 * dims[i] * dims[i + 1] for i in range(len(dims) - 1)))
