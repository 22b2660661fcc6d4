"""Logical sharding context (port of ``repro.sharding.ctx``).

Models are written against *logical* axis names ("batch", "seq", "embed",
"heads", "kv", "expert", "ff").  The distribution layer activates a mesh
and a logical->mesh translation; outside any context ``logical_constraint``
returns its argument, so the same model code runs on one device and on a
``torch.distributed`` device mesh unchanged.

The reference's mesh is a ``jax.sharding.Mesh`` and its constraint
``with_sharding_constraint``; here the mesh is a ``DeviceMesh`` with
``mesh_dim_names`` and the constraint is a ``DTensor.redistribute`` onto
the placements the translated spec names (``to_placements``).  A plain
tensor passes through: inside a mesh the models see DTensors only where
the params or the batch were placed on it.  Where DTensor has no sharding
rule for an op, the models state the collective GSPMD would insert:
``unshard`` gathers dims whole and ``rows_local`` runs a function on each
rank's rows (``local_map``).
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, Optional, Sequence, Tuple, Union

MeshAxes = Union[None, str, Tuple[str, ...]]


class PartitionSpec(tuple):
    """One entry per tensor dim: None (replicated), a mesh axis name, or a
    tuple of axis names (the dim split over all of them, the first the
    major one).  A tuple, printed as JAX's ``PartitionSpec``."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return "PartitionSpec(" + ", ".join(repr(a) for a in self) + ")"


P = PartitionSpec

_CTX: contextvars.ContextVar = contextvars.ContextVar("sharding_ctx",
                                                      default=None)


@contextlib.contextmanager
def activation_rules(mesh, rules: Dict[str, MeshAxes]):
    """Activate logical->mesh translation for ``logical_constraint`` calls
    (a context variable, so concurrent callers do not see each other's)."""
    token = _CTX.set({"mesh": mesh, "rules": dict(rules)})
    try:
        yield
    finally:
        _CTX.reset(token)


def current_mesh():
    ctx = _CTX.get()
    return None if ctx is None else ctx["mesh"]


def current_rules() -> Optional[Dict[str, MeshAxes]]:
    ctx = _CTX.get()
    return None if ctx is None else ctx["rules"]


def _translate(rules: Dict[str, MeshAxes], names: Sequence[Optional[str]],
               used: set) -> PartitionSpec:
    axes = []
    for name in names:
        mesh_ax = rules.get(name) if name is not None else None
        if mesh_ax is None:
            axes.append(None)
            continue
        # never assign the same mesh axis to two tensor dims
        if isinstance(mesh_ax, tuple):
            mesh_ax = tuple(a for a in mesh_ax if a not in used)
            mesh_ax = mesh_ax if mesh_ax else None
        elif mesh_ax in used:
            mesh_ax = None
        if mesh_ax is not None:
            for a in (mesh_ax if isinstance(mesh_ax, tuple) else (mesh_ax,)):
                used.add(a)
        axes.append(mesh_ax)
    return PartitionSpec(*axes)


def mesh_shape(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` (or of anything with a
    ``shape`` dict, as the reference's ``mesh.shape``)."""
    if isinstance(getattr(mesh, "shape", None), dict):
        return dict(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def to_placements(spec: Sequence[MeshAxes], mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: for each mesh dim, in
    the mesh's order, ``Shard(d)`` if tensor dim d names that axis, else
    ``Replicate()``.  A dim split over a tuple of axes is sharded on each
    of them in mesh order (the first the major one), the device order of
    JAX's ``NamedSharding``; a tuple out of mesh order has no such
    placement and raises.  A mesh dim of one rank is ``Replicate()``: its
    one shard is the whole tensor, and so no redistribution between the
    two ever copies it."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    sizes = mesh_shape(mesh)
    dim_of: Dict[str, int] = {}
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        axs = ax if isinstance(ax, tuple) else (ax,)
        idx = [names.index(a) for a in axs]
        if idx != sorted(idx):
            raise ValueError(f"axes {axs} of dim {d} are not in the mesh's "
                             f"order {names}")
        for a in axs:
            if a in dim_of:
                raise ValueError(f"mesh axis {a!r} shards two dims of {spec}")
            dim_of[a] = d
    return tuple(Shard(dim_of[n]) if n in dim_of and sizes[n] > 1
                 else Replicate() for n in names)


def logical_constraint(x, names: Sequence[Optional[str]]):
    """Constrain ``x`` (rank == len(names)) to the active logical sharding:
    a DTensor is redistributed onto the translated spec's placements,
    after ``fit_spec`` drops the axes that do not divide its dims.  The
    argument itself when no context is active or ``x`` is not a
    DTensor."""
    ctx = _CTX.get()
    if ctx is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    from repro_torch.sharding.specs import fit_spec
    mesh = ctx["mesh"]
    spec = fit_spec(_translate(ctx["rules"], names, set()), x.shape, mesh)
    placements = to_placements(spec, mesh)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(mesh, placements)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def unshard(x, dims: Sequence[int] = ()):
    """``x`` with tensor dims ``dims`` whole on every rank (and any pending
    sum reduced), its other shards kept: the collective GSPMD inserts
    before an op that DTensor has no sharding rule for.  A plain tensor
    passes through."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(x, DTensor):
        return x
    dims = {d % x.dim() for d in dims}
    pl = tuple(Replicate() if not isinstance(p, Shard) or p.dim in dims
               else p for p in x.placements)
    if pl == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, pl)


def unshard_for_local(x, dims: Sequence[int] = ()):
    """``unshard(x, dims)`` with every unevenly split dim whole as well (4
    heads over 3 ranks): ``local_map`` takes each rank's shard as an equal
    part of the whole."""
    from torch.distributed.tensor import Shard
    if not is_dtensor(x):
        return x
    n = [1] * x.dim()
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard):
            n[p.dim] *= x.device_mesh.size(i)
    return unshard(x, tuple(dims) + tuple(
        d for d in range(x.dim()) if x.shape[d] % n[d]))


def steps(n: int, device):
    """The steps a loop of ``n`` like steps runs on ``device``: all of
    them, or on ``meta``, which computes nothing (the dry run's structs),
    the first, one middle and the last (0, 1, n - 1), every op of each as
    a scan's body is traced once.  Under ``roofline.analysis`` the middle
    step counts for the n - 2 it stands for, so the analysis on ``meta``
    is that of the whole loop.  A loop whose result stacks its steps'
    outputs fills the missing ones with the last, detached (its gradient
    goes nowhere, as the steps it stands for are counted already)."""
    if device.type != "meta":
        return range(n)
    from repro_torch.roofline import analysis
    return analysis.loop(n)


def step_inputs(xs):
    """``xs.unbind(0)``: the inputs of a loop over ``steps(len(xs), ...)``.
    On ``meta`` with a gradient, the steps the loop skips have none, and
    the backward's stack takes the middle step's in their place (what
    ``roofline.analysis`` counts it for); the values are ``meta``'s, none."""
    if xs.device.type != "meta" or not xs.requires_grad or len(xs) <= 3:
        return xs.unbind(0)
    from repro_torch.roofline import analysis
    return analysis.cut_unbind(xs)


def _splits_badly(x, dim: int, lead: int) -> bool:
    """True when a mesh dim shards the DTensor ``x``'s ``dim`` in a way that
    splitting that dim into (``lead``, rest) cannot keep: ``lead`` is not a
    multiple of the shards."""
    from torch.distributed.tensor import Shard
    n = 1
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim == dim:
            n *= x.device_mesh.size(i)
    return lead % n != 0


def split_dim(x, dim: int, lead: int):
    """``x`` ready for its ``dim`` to be viewed as (``lead``, rest): the
    argument itself, or, where the dim's shards do not divide ``lead``
    (4 heads of a 16-way split), that dim whole on every rank, as GSPMD
    replicates what it cannot split.  A plain tensor passes through."""
    if is_dtensor(x) and _splits_badly(x, dim, lead):
        return unshard(x, (dim,))
    return x


def rows_local(fn, n_out: int, *xs, whole=None):
    """``fn(*xs[, whole])`` on each rank's local rows (dim 0) of the
    DTensors ``xs``, every other dim whole, and ``whole`` gathered whole on
    every rank; its ``n_out`` outputs come back split on dim 0 as the
    first input is (``local_map``).  Plain tensors call ``fn``."""
    extra = () if whole is None else (whole,)
    if not is_dtensor(xs[0]):
        return fn(*xs, *extra)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = xs[0].device_mesh
    x0 = unshard_for_local(xs[0], range(1, xs[0].dim()))
    rows = [p if isinstance(p, Shard) else Replicate() for p in x0.placements]
    rep = [Replicate()] * mesh.ndim
    ins = [x0] + [x.redistribute(mesh, rows) for x in xs[1:]]
    in_pl, grad_pl = [rows] * len(ins), [rows] * len(ins)
    if whole is not None:
        ins.append(whole.redistribute(mesh, rep))
        in_pl.append(rep)
        # each rank's gradient of ``whole`` sums over its own rows only
        grad_pl.append([Partial() if isinstance(p, Shard) else Replicate()
                        for p in rows])
    return local_map(fn, out_placements=tuple([rows] * n_out),
                     in_placements=tuple(in_pl),
                     in_grad_placements=tuple(grad_pl),
                     device_mesh=mesh)(*ins)


def param_sharding_rules(rules: Dict[str, MeshAxes],
                         names: Sequence[Optional[str]]) -> PartitionSpec:
    """Translate logical names to a PartitionSpec (for placing inputs)."""
    return _translate(dict(rules), names, set())
