"""Parameter trees: nested dicts/lists/tuples of tensors.

The port's counterpart of ``jax.tree``.  Leaves come out in
``jax.tree.flatten`` order, which visits dict keys SORTED (so an MLP layer
``{"w", "b"}`` yields ``b`` before ``w``) and sequences in order.  The flat
parameter rows of the aggregators and the per-leaf int8 scales depend on
this order matching the reference.
"""

from __future__ import annotations

from typing import Any, Callable, List


def leaves(tree: Any) -> List[Any]:
    """Leaves in ``jax.tree.leaves`` order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for item in tree for x in leaves(item)]
    return [tree]


def unflatten_like(template: Any, flat: List[Any]) -> Any:
    """Rebuild ``template``'s structure from leaves in ``leaves`` order."""
    it = iter(flat)

    def build(node):
        if isinstance(node, dict):
            out = {k: build(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}      # keep the caller's key order
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*[build(item) for item in node])  # NamedTuple
        if isinstance(node, (list, tuple)):
            return type(node)(build(item) for item in node)
        return next(it)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``jax.tree.map``: ``fn`` over corresponding leaves of same-shaped
    trees."""
    cols = [leaves(tree)] + [leaves(t) for t in rest]
    if any(len(c) != len(cols[0]) for c in cols):
        raise ValueError("trees have different numbers of leaves")
    return unflatten_like(tree, [fn(*xs) for xs in zip(*cols)])


def tree_stack(trees: List[Any]) -> Any:
    """Stack same-shaped trees leaf by leaf along a new leading axis (the
    lane axis of a packed cohort or of a stacked evaluation)."""
    import torch
    cols = [leaves(t) for t in trees]
    return unflatten_like(trees[0], [torch.stack(ls) for ls in zip(*cols)])
