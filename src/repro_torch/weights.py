"""Carry parameters between the JAX package and the port as numpy arrays.

``torch`` cannot reproduce ``jax.random``, so a run that must start where
the reference starts takes the reference's initial params (as numpy, e.g.
``jax.tree.map(np.asarray, model.init(key))``) through
``params_from_numpy``.  ``params_to_numpy`` carries the port's params back.
Both keep the nested dict/list shape and check every leaf's shape and dtype.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.tree import leaves, unflatten_like

_DTYPES = {np.dtype(np.float32): torch.float32,
           np.dtype(np.float64): torch.float64,
           np.dtype(np.int32): torch.int32,
           np.dtype(np.int64): torch.int64}


def params_from_numpy(tree: Any, device, template: Optional[Any] = None
                      ) -> Any:
    """Numpy leaves -> tensors on ``device``, same tree shape.  With
    ``template`` (e.g. the port's ``model.init``), every leaf must match
    the template leaf's shape and dtype; a mismatch raises."""
    arrays = [np.asarray(a) for a in leaves(tree)]
    for a in arrays:
        if a.dtype not in _DTYPES:
            raise TypeError(f"unsupported parameter dtype {a.dtype}")
    if template is not None:
        want = leaves(template)
        if len(want) != len(arrays):
            raise ValueError(f"tree has {len(arrays)} leaves, template "
                             f"{len(want)}")
        for i, (a, t) in enumerate(zip(arrays, want)):
            if tuple(a.shape) != tuple(t.shape) or _DTYPES[a.dtype] != t.dtype:
                raise ValueError(
                    f"leaf {i}: got {tuple(a.shape)} {a.dtype}, template "
                    f"wants {tuple(t.shape)} {t.dtype}")
    dev = torch.device(device)
    return unflatten_like(tree, [
        torch.from_numpy(np.array(a)).to(dev) for a in arrays])


def params_to_numpy(params: Any) -> Any:
    """Tensors -> numpy arrays on the host, same tree shape."""
    out = []
    for t in leaves(params):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"parameter leaf is {type(t).__name__}, not a "
                            "tensor")
        out.append(t.detach().cpu().numpy())
    return unflatten_like(params, out)
