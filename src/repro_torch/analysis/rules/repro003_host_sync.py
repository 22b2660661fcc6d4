"""REPRO003 — host syncs inside per-step loops.

The reference's REPRO003 guards tracer-unsafe Python inside jitted
scopes.  The port has no tracer; its counterpart hazard is the host sync:
``.item()``, ``.tolist()`` and ``float()``/``int()``/``bool()`` of a tensor
block the host until the card has finished everything queued before it,
so one inside a per-step loop (a round's clients, an epoch's batches, a
queue's events) serialises host and card on every iteration.  In
``runtime/``, ``experiments/`` and ``federated/`` such a call inside a
``for``/``while`` loop or a comprehension is flagged: gather the values
on the card and bring them over once, after the loop, or justify the
sync.

``.item()``/``.tolist()`` are flagged on any receiver, and a cast on any
argument that the function does not show to be a host value: a literal,
a ``len``/``str``/cast/``round`` call, a ``numpy.*`` or ``math.*`` call,
a tensor's ``.shape``/``.ndim`` or a host-result method (``.item()``,
``.numel()``, ...), a parameter annotated ``int``/``float``/``bool``/
``str``, a loop variable over a host value (``range``, ``enumerate``'s
index) or a name bound to a host expression, and arithmetic, indexing or
comparison of those.  Whatever it cannot place (an attribute, an
unannotated parameter, a call's result) may be a tensor, so it is flagged.
"""

from __future__ import annotations

import ast
from typing import Set

from ..core import FileContext, Rule, register
from ..scopes import FuncNode, dotted_parts, final_name

SCOPED_DIRS = {"runtime", "experiments", "federated"}
SYNC_METHODS = {"item", "tolist"}
HOST_CASTS = {"float", "int", "bool"}
# methods whose result is not a tensor even on a tensor receiver
HOST_RESULTS = {"item", "tolist", "numpy", "dim", "size", "numel",
                "element_size", "stride", "data_ptr", "is_contiguous"}
LOOPS = (ast.For, ast.AsyncFor, ast.While, ast.ListComp, ast.SetComp,
         ast.DictComp, ast.GeneratorExp)


HOST_FUNCS = {"len", "str", "int", "float", "bool", "round", "range",
              "repr", "hash", "id", "ord", "chr", "isinstance"}
HOST_MODULES = {"np", "numpy", "math", "time", "os", "random", "json"}
HOST_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda"}
HOST_TYPES = {"int", "float", "bool", "str"}


def _annotated_host(ann) -> bool:
    if ann is None:
        return False
    if isinstance(ann, ast.Subscript):     # Optional[int], List[int]
        return _annotated_host(ann.slice)
    if isinstance(ann, ast.Tuple):
        return all(_annotated_host(e) for e in ann.elts)
    return dotted_parts(ann)[-1:] and dotted_parts(ann)[-1] in HOST_TYPES


def _is_host(expr: ast.AST, names: Set[str]) -> bool:
    """True when ``expr`` is a host value as far as the function shows."""
    if isinstance(expr, (ast.Constant, ast.JoinedStr)):
        return True
    if isinstance(expr, ast.Name):
        return expr.id in names
    if isinstance(expr, ast.Attribute):
        return expr.attr in HOST_ATTRS
    if isinstance(expr, ast.Call):
        chain = dotted_parts(expr.func)
        if isinstance(expr.func, ast.Name):
            return expr.func.id in HOST_FUNCS
        if chain and chain[0] in HOST_MODULES:
            return True
        # a host-result method, or any method of a host value (numpy's)
        return isinstance(expr.func, ast.Attribute) and (
            expr.func.attr in HOST_RESULTS
            or _is_host(expr.func.value, names))
    if isinstance(expr, ast.Subscript):
        return _is_host(expr.value, names)
    if isinstance(expr, ast.BinOp):
        return _is_host(expr.left, names) and _is_host(expr.right, names)
    if isinstance(expr, ast.UnaryOp):
        return _is_host(expr.operand, names)
    if isinstance(expr, ast.BoolOp):
        return all(_is_host(e, names) for e in expr.values)
    if isinstance(expr, ast.Compare):
        return all(_is_host(e, names)
                   for e in [expr.left] + expr.comparators)
    if isinstance(expr, ast.IfExp):
        return _is_host(expr.body, names) and _is_host(expr.orelse, names)
    if isinstance(expr, (ast.Tuple, ast.List)):
        return all(_is_host(e, names) for e in expr.elts)
    return False


def _target_names(tgt) -> Set[str]:
    return {n.id for n in ast.walk(tgt) if isinstance(n, ast.Name)}


def _host_names(func) -> Set[str]:
    """Names in ``func`` that hold host values: parameters annotated
    ``int``/``float``/``bool``/``str``, names bound to host expressions,
    and loop variables over host values or ``enumerate``'s index (to a
    fixpoint)."""
    a = func.args
    names = {p.arg for p in a.args + a.posonlyargs + a.kwonlyargs
             if _annotated_host(p.annotation)}
    binds = []
    for n in ast.walk(func):
        if isinstance(n, ast.Assign):
            binds += [(t, n.value) for t in n.targets]
        elif isinstance(n, (ast.AnnAssign, ast.AugAssign)) and n.value:
            binds.append((n.target, n.value))
        elif isinstance(n, (ast.For, ast.AsyncFor, ast.comprehension)):
            it = n.iter
            if isinstance(it, ast.Call) and final_name(it.func) == \
                    "enumerate" and isinstance(n.target, ast.Tuple) \
                    and isinstance(n.target.elts[0], ast.Name):
                names.add(n.target.elts[0].id)
            else:
                binds.append((n.target, it))
    changed = True
    while changed:
        changed = False
        for tgt, value in binds:
            if isinstance(tgt, ast.Name) and isinstance(tgt.ctx, ast.Store) \
                    and tgt.id not in names and _is_host(value, names):
                names.add(tgt.id)
                changed = True
            elif isinstance(tgt, ast.Tuple) and _is_host(value, names):
                new = _target_names(tgt) - names
                if new:
                    names |= new
                    changed = True
    # a name also bound to what the function cannot place is not proved
    for tgt, value in binds:
        if isinstance(tgt, ast.Name) and not _is_host(value, names):
            names.discard(tgt.id)
    return names


def _in_loop(ctx: FileContext, node: ast.AST) -> bool:
    for anc in ctx.ancestors(node):
        if isinstance(anc, LOOPS):
            return True
        if isinstance(anc, FuncNode + (ast.Lambda,)):
            return False
    return False


@register
class HostSyncInLoop(Rule):
    id = "REPRO003"
    name = "host-sync-in-step-loop"

    def check_file(self, ctx: FileContext):
        if not set(ctx.rel.split("/")) & SCOPED_DIRS:
            return
        for func in ast.walk(ctx.tree):
            if not isinstance(func, FuncNode):
                continue
            names = _host_names(func)
            for node in ast.walk(func):
                if not isinstance(node, ast.Call) or \
                        ctx.enclosing_function(node) is not func or \
                        not _in_loop(ctx, node):
                    continue
                self._check_call(ctx, node, names)

    def _check_call(self, ctx: FileContext, node: ast.Call, names):
        name = final_name(node.func)
        if isinstance(node.func, ast.Attribute) and name in SYNC_METHODS \
                and not node.args:
            ctx.add(node, self.id,
                    f"`.{name}()` inside a per-step loop syncs the host "
                    "with the card every iteration — gather on the card "
                    "and bring the values over once, after the loop")
        elif isinstance(node.func, ast.Name) and name in HOST_CASTS \
                and len(node.args) == 1 \
                and not _is_host(node.args[0], names):
            ctx.add(node, self.id,
                    f"`{name}()` of what may be a tensor inside a per-step "
                    "loop syncs the host with the card every iteration — "
                    "gather on the card and bring the values over once, "
                    "after the loop")
