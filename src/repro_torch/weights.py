"""Carry parameters between the JAX package and the port as numpy arrays.

``torch`` cannot reproduce ``jax.random``, so a run that must start where
the reference starts takes the reference's initial params (as numpy, e.g.
``jax.tree.map(np.asarray, model.init(key))``) through
``params_from_numpy``.  ``params_to_numpy`` carries the port's params back.
Both keep the nested dict/list shape and check every leaf's shape and dtype.
``params_to_mesh`` places such a tree on a device mesh by
``param_shardings`` (each rank keeps its shard of the same params) and
``params_from_mesh`` gathers it back to numpy.

numpy has no bfloat16.  A bf16 leaf crosses as its raw 2-byte pattern: a
``uint16`` array, or the void ``|V2`` array numpy reads back for the
reference's ``ml_dtypes.bfloat16``, plus the dtype name ``"bfloat16"``.
Nothing here imports ``ml_dtypes``.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.tree import leaves, unflatten_like

_DTYPES = {np.dtype(np.float32): torch.float32,
           np.dtype(np.float64): torch.float64,
           np.dtype(np.int32): torch.int32,
           np.dtype(np.int64): torch.int64}
BF16 = "bfloat16"


def tensor_from_numpy(a: np.ndarray, device,
                      dtype_name: Optional[str] = None) -> torch.Tensor:
    """One array as a tensor on ``device`` (a copy).  ``dtype_name ==
    "bfloat16"``, or a ``|V2`` array, gives a ``torch.bfloat16`` tensor
    with the array's bits."""
    a = np.asarray(a)
    if dtype_name == BF16 or a.dtype.kind == "V":
        if a.dtype.itemsize != 2:
            raise TypeError(f"a bfloat16 leaf needs 2-byte elements, got "
                            f"{a.dtype}")
        raw = np.ascontiguousarray(a).view(np.int16).copy()
        return torch.from_numpy(raw).view(torch.bfloat16).to(device)
    if a.dtype not in _DTYPES:
        raise TypeError(f"unsupported parameter dtype {a.dtype}")
    return torch.from_numpy(np.array(a)).to(device)


def tensor_to_numpy(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """A tensor on the host as (array, dtype name): bf16 as its ``uint16``
    bit pattern named ``"bfloat16"``."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), BF16
    a = t.numpy()
    return a, a.dtype.name


def params_from_numpy(tree: Any, device, template: Optional[Any] = None,
                      dtype_names: Optional[Sequence[Optional[str]]] = None
                      ) -> Any:
    """Numpy leaves -> tensors on ``device``, same tree shape.  With
    ``template`` (e.g. the port's ``model.init``), every leaf must match
    the template leaf's shape and dtype; a mismatch raises.  A leaf is
    bf16 when ``dtype_names`` (one name or None per leaf, in ``leaves``
    order) says ``"bfloat16"``, when its template leaf is bf16, or when it
    is a ``|V2`` array."""
    arrays = [np.asarray(a) for a in leaves(tree)]
    want = leaves(template) if template is not None else None
    if want is not None and len(want) != len(arrays):
        raise ValueError(f"tree has {len(arrays)} leaves, template "
                         f"{len(want)}")
    names = list(dtype_names) if dtype_names is not None else \
        [None] * len(arrays)
    if want is not None:
        names = [BF16 if t.dtype == torch.bfloat16 else n
                 for n, t in zip(names, want)]
    out = [tensor_from_numpy(a, device, n) for a, n in zip(arrays, names)]
    if want is not None:
        for i, (o, t) in enumerate(zip(out, want)):
            if tuple(o.shape) != tuple(t.shape) or o.dtype != t.dtype:
                raise ValueError(
                    f"leaf {i}: got {tuple(o.shape)} {o.dtype}, template "
                    f"wants {tuple(t.shape)} {t.dtype}")
    return unflatten_like(tree, out)


def params_to_numpy(params: Any) -> Any:
    """Tensors -> numpy arrays on the host, same tree shape (bf16 leaves
    as their ``uint16`` bit patterns)."""
    out = []
    for t in leaves(params):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"parameter leaf is {type(t).__name__}, not a "
                            "tensor")
        out.append(tensor_to_numpy(t)[0])
    return unflatten_like(params, out)


def params_to_mesh(tree: Any, mesh, rules, device,
                   template: Optional[Any] = None,
                   dtype_names: Optional[Sequence[Optional[str]]] = None
                   ) -> Any:
    """Numpy leaves (the same on every rank) -> DTensors on ``mesh``,
    placed by ``sharding.specs.param_shardings`` under ``rules``; each
    rank keeps only its shard (no collective).  ``device``, ``template``
    and ``dtype_names`` as in ``params_from_numpy``."""
    from repro_torch.sharding.specs import place_params
    return place_params(params_from_numpy(tree, device, template,
                                          dtype_names), mesh, rules)


def params_from_mesh(params: Any) -> Any:
    """The inverse of ``params_to_mesh``: every DTensor leaf gathered whole
    (a collective on every rank of its mesh), then ``params_to_numpy``."""
    from repro_torch.sharding.specs import gather_tree
    return params_to_numpy(gather_tree(params))
