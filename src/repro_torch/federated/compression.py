"""Upload compression (beyond-paper): int8-quantised client deltas.

Counterpart of ``repro.federated.compression``.  Clients upload quantised
``theta_k - theta`` instead of full-precision parameters, cutting TransL by
~4x on the upload half of each round; the server dequantises before
aggregation.  The cost model sees the reduction through ``upload_factor``.

The round trip follows the reference's jitted graph as XLA compiles it
(see ``kernels/ref.py``): per-leaf scale ``max(max|d| * RECIP_127, 1e-12)``,
round half to even, and a fused multiply-add to dequantise.  The lane
variants (``lane_roundtrip``, ``compress_delta_lanes``, ``lane_mask``) run
the same round trip over an (M, ...)-stacked cohort, lane i against its own
reference params; every operation is elementwise except the per-lane
``amax``, which is exact, so lane i equals ``compress_delta`` on that lane's
pair bit for bit.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np
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


def _roundtrip_lanes(g: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``_roundtrip_leaf`` over a leading lane axis: one scale per lane."""
    delta = (c - g).to(torch.float32)
    m = delta.shape[0]
    lane_max = delta.abs().reshape(m, -1).amax(dim=1)
    scale = torch.clamp_min(lane_max * RECIP_127, 1e-12)
    scale = scale.reshape((m,) + (1,) * (delta.dim() - 1)).expand_as(delta)
    q = torch.clamp(torch.round(delta / scale), -127, 127).to(torch.int8)
    return _fma_f32(q.to(torch.float32), scale,
                    g.to(torch.float32)).to(g.dtype)


def lane_roundtrip(global_b: Any, params_b: Any,
                   enabled: Optional[torch.Tensor] = None) -> Any:
    """The round trip over an (M, ...)-stacked cohort: lane i is quantised
    against ITS reference params ``global_b[i]`` (the trial's dispatch-time
    global model).  ``enabled`` is an optional (M,) bool mask: lanes of
    uncompressed trials pass through unchanged, so mixed grids pack into
    one cohort."""
    def leaf(g, c):
        rec = _roundtrip_lanes(g, c)
        if enabled is None:
            return rec
        gate = enabled.to(device=c.device, dtype=torch.bool)
        return torch.where(gate.reshape((-1,) + (1,) * (rec.dim() - 1)),
                           rec, c)
    return tree_map(leaf, global_b, params_b)


def compress_delta_lanes(global_b: Any, params_b: Any,
                         enabled=None) -> Any:
    """Entry point for the cohort packers: ``lane_roundtrip`` with the mask
    given as numpy or a tensor; lane i equals ``compress_delta`` on that
    lane's (global, params) pair bit for bit."""
    if enabled is not None and not isinstance(enabled, torch.Tensor):
        enabled = torch.from_numpy(np.asarray(enabled, np.bool_))
    return lane_roundtrip(global_b, params_b, enabled)


def lane_mask(methods: Sequence[Optional[str]]) -> Optional[np.ndarray]:
    """Per-lane enable mask from the lanes' ``TrialSpec.compression``
    values; None when no lane compresses (the packers skip the transform
    entirely).  Unknown methods raise, naming the valid ones."""
    for m in methods:
        upload_factor(m)
    mask = np.array([m not in (None, "none") for m in methods], bool)
    return mask if mask.any() else None


def upload_factor(method: str | None) -> float:
    try:
        return FACTORS[method]
    except KeyError:
        valid = ", ".join(repr(k) for k in FACTORS)
        raise ValueError(
            f"unknown compression method {method!r}; valid methods: {valid}"
        ) from None
