"""Partition rules: logical tensor dims -> mesh axes (port of
``repro.sharding.specs``, with the same tables).

Strategy (MaxText-style FSDP + TP, adapted for federated rounds):
  * "residual" (d_model-like param dims)  -> "data"  (FSDP; the round-start
    all-gather IS the FL model download)
  * "ff" / "heads" / "expert" / "vocab"   -> "model" (tensor / expert parallel)
  * "batch" activations                   -> ("pod", "data")
  * pods replicate params: each pod is an FL silo; the cross-pod weighted
    sum of the train step's gradient is the FL aggregation (upload).

Parameter tensors are matched by their *name* (the last dict key on their
path), which the model zoo keeps globally consistent.  A spec is a
``PartitionSpec`` (``ctx``); ``param_shardings`` turns it into DTensor
placements on a ``DeviceMesh`` after ``fit_spec``: DTensor accepts a dim
that does not split evenly (8 heads over 16 ranks: one head on some ranks,
none on others), where the reference replicates it, so the fit comes
first.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

from repro_torch.sharding.ctx import (PartitionSpec as P, mesh_shape,
                                      to_placements)

# logical dim names per parameter tensor name (by rank-matched tuple)
_PARAM_LOGICAL: Dict[str, Tuple[Optional[str], ...]] = {
    # embeddings / heads
    "embed": ("vocab", "residual"),
    "lm_head": ("residual", "vocab"),
    "frontend_proj": (None, "residual"),
    # attention
    "wq": ("residual", "heads", None),
    "wk": ("residual", "kv_heads", None),
    "wv": ("residual", "kv_heads", None),
    "wo": ("heads", None, "residual"),
    "bq": ("heads", None),
    "bk": ("kv_heads", None),
    "bv": ("kv_heads", None),
    # dense mlp
    "w_gate": ("residual", "ff"),
    "w_up": ("residual", "ff"),
    "w_down": ("ff", "residual"),
    # moe (rank-3 variants of the same names handled by rank dispatch below)
    "router": ("residual", "expert"),
    # rglru
    "w_in": ("residual", "ff"),
    "w_gate_branch": ("residual", "ff"),
    "conv_w": (None, "ff"),
    "w_out": ("ff", "residual"),
    # xlstm
    "w_z": ("residual", "ff"),
    "w_q": ("heads", None, None),
    "w_k": ("heads", None, None),
    "w_v": ("heads", None, None),
    "w_i": ("ff", None),
    "w_f": ("ff", None),
    "w_z_gate": ("residual", "residual_out"),
    "r_z": ("heads", None, None),
    "r_i": ("heads", None, None),
    "r_f": ("heads", None, None),
    "r_o": ("heads", None, None),
    "w_o": ("residual", "residual_out"),
    # resnet / misc
    "head_w": (None, None),
}

_MOE_LOGICAL = {  # rank-3 moe expert weights (distinct names: we_*)
    "we_gate": ("expert", "residual", "moe_inner"),
    "we_up": ("expert", "residual", "moe_inner"),
    "we_down": ("expert", "moe_inner", "residual"),
}


# logical -> mesh translation tables ---------------------------------------

def train_rules(multi_pod: bool) -> Dict[str, Any]:
    return {
        # params
        "residual": "data",
        "residual_out": None,
        "ff": "model",
        "heads": "model",
        "kv_heads": "model",
        "expert": "model",
        "vocab": "model",
        # activations
        "batch": ("pod", "data") if multi_pod else "data",
        "seq": "model",   # sequence parallelism for the residual stream
        "embed": None,
        # expert-buffer capacity / flat dispatch dims follow the batch axes
        "moe_capacity": ("pod", "data") if multi_pod else "data",
        "moe_tokens": ("pod", "data") if multi_pod else "data",
        "moe_inner": None,   # expert d_ff dim: sharded only at decode
    }


def decode_rules(multi_pod: bool, *, shard_seq: bool = False
                 ) -> Dict[str, Any]:
    r = train_rules(multi_pod)
    # weights stay 2D-sharded ("data" x "model") at serve time as well:
    # 100B+ checkpoints exceed device memory under model-axis-only sharding.
    if shard_seq:                 # long-context: batch too small, shard cache seq
        r["batch"] = None
        r["cache_seq"] = (("pod", "data", "model") if multi_pod
                          else ("data", "model"))
    else:
        # KV cache is sequence-sharded over the model axis (kv-head counts
        # rarely divide 16; seq always does).
        r["cache_seq"] = "model"
    r["seq"] = None               # no sequence parallelism at decode
    return r


LOGICAL_RULES = train_rules(False)


# ---------------------------------------------------------------------------
# trees with paths
# ---------------------------------------------------------------------------

def tree_map_with_path(fn: Callable[[tuple, Any], Any], tree: Any,
                       *rest: Any, path: tuple = ()) -> Any:
    """``jax.tree_util.tree_map_with_path`` over the port's trees: ``fn(
    path, leaf, *rest_leaves)``, the path a tuple of ``("key", k)`` (dict),
    ``("attr", name)`` (NamedTuple field) and ``("idx", i)`` (sequence)
    entries.  None is a leaf."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, tree[k], *[r[k] for r in rest],
                                      path=path + (("key", k),))
                for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[
            tree_map_with_path(fn, v, *[getattr(r, f) for r in rest],
                               path=path + (("attr", f),))
            for f, v in zip(tree._fields, tree)])
    if isinstance(tree, (list, tuple)):
        return type(tree)(
            tree_map_with_path(fn, v, *[r[i] for r in rest],
                               path=path + (("idx", i),))
            for i, v in enumerate(tree))
    return fn(path, tree, *rest)


def _last(path, kind: str):
    for k, v in reversed(path):
        if k == kind:
            return v
    return None


# ---------------------------------------------------------------------------
# param / cache / input specs
# ---------------------------------------------------------------------------

def _translate(logical: Tuple[Optional[str], ...], rules: Dict[str, Any]
               ) -> P:
    used: set = set()
    axes = []
    for name in logical:
        ax = rules.get(name) if name else None
        if isinstance(ax, tuple):
            ax = tuple(a for a in ax if a not in used) or None
        elif ax in used:
            ax = None
        if ax is not None:
            used.update(ax if isinstance(ax, tuple) else (ax,))
        axes.append(ax)
    return P(*axes)


def _spec_for_param(path, leaf, rules: Dict[str, Any]) -> P:
    name = _last(path, "key")
    rank = len(leaf.shape)
    logical = None
    stacked = False  # the stacked layout adds a leading (n_cycles) dim
    if name in _MOE_LOGICAL and rank in (3, 4):
        logical = _MOE_LOGICAL[name]
        stacked = rank == 4
    elif name in _PARAM_LOGICAL:
        want = len(_PARAM_LOGICAL[name])
        if rank == want:
            logical = _PARAM_LOGICAL[name]
        elif rank == want + 1:
            logical = _PARAM_LOGICAL[name]
            stacked = True
    if logical is None:
        return P()  # replicate (norms, biases, small tensors)
    if stacked:
        logical = (None,) + tuple(logical)
    return _translate(logical, rules)


def fit_spec(spec: P, shape, mesh) -> P:
    """Drop mesh axes that do not evenly divide the tensor dim (replication
    is the safe fallback for small dims like 4 kv heads on a 16-way model
    axis)."""
    sizes = mesh_shape(mesh)
    axes = []
    for d, ax in enumerate(spec):
        if ax is None:
            axes.append(None)
            continue
        ax_tuple = ax if isinstance(ax, tuple) else (ax,)
        keep = []
        prod = 1
        for a in ax_tuple:
            size = sizes[a]
            if shape[d] % (prod * size) == 0:
                keep.append(a)
                prod *= size
        axes.append(tuple(keep) if len(keep) > 1
                    else (keep[0] if keep else None))
    # pad trailing dims
    axes += [None] * (len(shape) - len(axes))
    return P(*axes[:len(shape)])


def param_specs(params, rules: Dict[str, Any]):
    """PartitionSpec tree matching ``params`` (tensors on any device,
    ``meta`` included)."""
    return tree_map_with_path(
        lambda path, leaf: _spec_for_param(path, leaf, rules), params)


def param_shardings(params, mesh, rules: Dict[str, Any]):
    """The DTensor placements of every leaf: its ``param_specs`` entry
    fitted to its shape (``fit_spec``), then ``to_placements``."""
    return tree_map_with_path(
        lambda path, leaf: to_placements(
            fit_spec(_spec_for_param(path, leaf, rules), leaf.shape, mesh),
            mesh), params)


def _place(x, mesh, placements):
    """``x`` as a DTensor on ``mesh``: a DTensor is redistributed; a plain
    tensor, the same on every rank, is cut locally (no collective)."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    if isinstance(x, DTensor):
        return x.redistribute(mesh, placements)
    return distribute_tensor(x, mesh, placements, src_data_rank=None)


def place_params(params, mesh, rules: Dict[str, Any]):
    """``params`` (the same tensors on every rank, or DTensors) placed on
    ``mesh`` by ``param_shardings``: each rank keeps its shard."""
    return tree_map_with_path(
        lambda path, leaf: _place(leaf, mesh, to_placements(
            fit_spec(_spec_for_param(path, leaf, rules), leaf.shape, mesh),
            mesh)), params)


def place_like(tree, like):
    """``tree``'s leaves placed as ``like``'s DTensor leaves are (the
    momentum beside its params)."""
    return tree_map_with_path(
        lambda path, x, ref: _place(x, ref.device_mesh, ref.placements),
        tree, like)


def place_cache(cache, mesh, rules: Dict[str, Any]):
    """A decode cache placed on ``mesh`` by ``cache_specs`` through
    ``fit_spec`` (the reference's serve step's cache shardings)."""
    return tree_map_with_path(
        lambda path, leaf, spec: _place(
            leaf, mesh, to_placements(fit_spec(spec, leaf.shape, mesh),
                                      mesh)),
        cache, cache_specs(cache, rules))


def place_batch(x, mesh, rules: Dict[str, Any]):
    """An input's leading (batch) dim on the rules' ``batch`` axes, through
    ``fit_spec``; the rest whole."""
    spec = P(*([rules.get("batch")] + [None] * (x.dim() - 1)))
    return _place(x, mesh, to_placements(fit_spec(spec, x.shape, mesh),
                                         mesh))


def gather_tree(tree):
    """Every DTensor leaf gathered whole (``full_tensor``); plain leaves as
    they are."""
    from torch.distributed.tensor import DTensor
    return tree_map_with_path(
        lambda path, x: x.full_tensor() if isinstance(x, DTensor) else x,
        tree)


def cache_specs(cache, rules: Dict[str, Any]):
    """Specs for a decode cache tree (``KVCache`` / recurrent states)."""
    batch_ax = rules.get("batch")
    seq_ax = rules.get("cache_seq")
    model_ax = rules.get("heads")

    def base_spec(field, rank):
        if field in ("k", "v") and rank == 4:      # (B, C, Kh, D)
            return P(batch_ax, seq_ax,
                     model_ax if seq_ax is None else None, None)
        if field == "slot_pos" and rank == 1:
            return P(seq_ax if seq_ax is not None else None)
        if field == "enc_out" and rank == 3:
            return P(batch_ax, None, None)
        if field == "h" and rank == 2:             # rglru (B, W)
            return P(batch_ax, model_ax)
        if field == "conv_tail" and rank == 3:
            return P(batch_ax, None, model_ax)
        if field == "C" and rank == 4:             # mlstm (B, H, hd, hd)
            return P(batch_ax, model_ax, None, None)
        if field == "n" and rank == 3:
            return P(batch_ax, model_ax, None)
        if field == "m" and rank == 2:
            return P(batch_ax, model_ax)
        if rank == 2:                              # slstm c/n/h (B, d)
            return P(batch_ax, model_ax)
        return None

    def spec(path, leaf):
        rank = len(leaf.shape)
        field = _last(path, "attr") or _last(path, "key")
        s = base_spec(field, rank)
        if s is not None:
            return s
        s = base_spec(field, rank - 1)  # stacked (+1 leading layer dim)
        if s is not None:
            return P(*((None,) + tuple(s)))
        return P()

    return tree_map_with_path(spec, cache)


def clients_spec(rank: int, client_dim: int, axis: str = "clients") -> P:
    """PartitionSpec placing a cohort tensor's client dim on the ``clients``
    mesh axis with everything else replicated: the layout contract of the
    (T, M, B, ...) stacked cohort arrays of ``runtime/sharded.py``."""
    axes: list = [None] * rank
    axes[client_dim] = axis
    return P(*axes)


def input_specs_sharding(kind: str, rules: Dict[str, Any]):
    """Specs for batch inputs by input name."""
    batch_ax = rules.get("batch")

    def spec(name: str, rank: int) -> P:
        if rank == 0:
            return P()
        axes = [batch_ax] + [None] * (rank - 1)
        return P(*axes)

    return spec
