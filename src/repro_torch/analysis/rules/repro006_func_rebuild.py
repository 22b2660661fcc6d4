"""REPRO006 — ``torch.func`` wrappers rebuilt inside a loop.

The reference's REPRO006 guards ``jax.jit``'s compile cache.  The port
compiles nothing, but ``torch.func.vmap``/``grad`` wrappers and the
closures that call ``torch.func.functional_call`` are still objects built
on the host: one built inside a per-round or per-batch loop is rebuilt
(and its function's closure with it) every iteration, where one built
once and kept would serve (``runtime/batched.py``,
``federated/evaluation.py``).  Such a construction inside a ``for`` or
``while`` loop is flagged, unless the enclosing scope is visibly a cache
(a cache-flavored name in the enclosing function, a Cache-named class, or
an ``lru_cache`` decorator), as the reference recognises its caches.
"""

from __future__ import annotations

import ast

from ..core import FileContext, Rule, register
from ..scopes import FuncNode, dotted_parts, final_name

WRAPPERS = {"vmap", "grad", "grad_and_value", "jacrev", "jacfwd",
            "hessian", "functionalize"}


def _cache_marker(ctx: FileContext, node: ast.AST) -> bool:
    """True when the construction site is visibly cache-guarded: a
    'cache'-flavored name in the enclosing function, a Cache-named
    enclosing class, or an lru_cache/cache decorator."""
    fn = ctx.enclosing_function(node)
    if fn is not None:
        for dec in fn.decorator_list:
            if final_name(dec) in {"lru_cache", "cache"} or (
                    isinstance(dec, ast.Call)
                    and final_name(dec.func) in {"lru_cache", "cache"}):
                return True
        for sub in ast.walk(fn):
            if isinstance(sub, (ast.Name, ast.Attribute)):
                if any("cache" in p.lower() for p in dotted_parts(sub)):
                    return True
    for anc in ctx.ancestors(node):
        if isinstance(anc, ast.ClassDef) and "cache" in anc.name.lower():
            return True
    return False


def _calls_functional_call(node) -> bool:
    body = node.body if isinstance(node, ast.Lambda) else node
    return any(isinstance(n, ast.Call)
               and final_name(n.func) == "functional_call"
               for n in ast.walk(body))


@register
class FuncWrapperRebuilt(Rule):
    id = "REPRO006"
    name = "torch-func-wrapper-rebuilt"

    def check_file(self, ctx: FileContext):
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Call) \
                    and final_name(node.func) in WRAPPERS \
                    and (isinstance(node.func, ast.Name)
                         or "func" in dotted_parts(node.func)):
                what = f"`{'.'.join(dotted_parts(node.func))}` wrapper"
            elif isinstance(node, FuncNode + (ast.Lambda,)) \
                    and _calls_functional_call(node):
                what = "closure over `functional_call`"
            else:
                continue
            if ctx.enclosing_loop(node) is None or _cache_marker(ctx, node):
                continue
            ctx.add(node, self.id,
                    f"{what} built inside a loop — every iteration builds "
                    "it again; build it once outside the loop or keep it "
                    "in a cache")
