"""Upload compression (beyond-paper): int8-quantised client deltas.

Counterpart of ``repro.federated.compression``.  Clients upload quantised
``theta_k - theta`` instead of full-precision parameters, cutting TransL by
~4x on the upload half of each round; the server dequantises before
aggregation.  The cost model sees the reduction through ``upload_factor``.

The round trip follows the reference's jitted graph as XLA compiles it
(see ``kernels/ref.py``): per-leaf scale ``max(max|d| * RECIP_127, 1e-12)``,
round half to even, and a fused multiply-add to dequantise.  The lane
variants (``compress_delta_lanes``, ``lane_mask``) come with the sweep
engine's slice.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.kernels.ref import RECIP_127, _fma_f32
from repro_torch.tree import tree_map

# bytes(transmitted)/bytes(f32) for the upload half of a round
FACTORS = {None: 1.0, "none": 1.0, "int8": 0.25 + 1e-3}


def _roundtrip_leaf(g: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """One leaf's quantise->transmit->dequantise simulation: symmetric int8
    over the delta, per-leaf scale, zero deltas reconstruct exactly (the
    1e-12 clamp only guards the 0/0 of an all-zero delta)."""
    delta = (c - g).to(torch.float32)
    scale = torch.clamp_min(delta.abs().amax() * RECIP_127, 1e-12)
    q = torch.clamp(torch.round(delta / scale), -127, 127).to(torch.int8)
    return _fma_f32(q.to(torch.float32), scale.expand_as(delta),
                    g.to(torch.float32)).to(g.dtype)


def compress_delta(global_params: Any, client_params: Any,
                   method: str = "int8") -> Any:
    """Simulate the quantise->transmit->dequantise round trip and return the
    client params the SERVER reconstructs."""
    if method in (None, "none"):
        return client_params
    upload_factor(method)          # ValueError naming valid methods
    return tree_map(_roundtrip_leaf, global_params, client_params)


def upload_factor(method: str | None) -> float:
    try:
        return FACTORS[method]
    except KeyError:
        valid = ", ".join(repr(k) for k in FACTORS)
        raise ValueError(
            f"unknown compression method {method!r}; valid methods: {valid}"
        ) from None
