"""Jit-scope model: which functions execute under a JAX tracing transform.

The parity rules need to distinguish *traced* code (compiled once, FMA
contraction and tracer semantics apply) from *eager* code (host-side
``jnp`` dispatch, one kernel per op).  Decorators alone are not enough:
``compression._roundtrip_leaf`` carries no decorator but only ever runs
inside ``jax.vmap(...)`` / jitted callers, so REPRO001 must treat it as
traced while flagging the byte-identical pattern at module level.

A function counts as TRACED when any of:

1. it is decorated with a tracing wrapper (``jax.jit``, ``vmap``,
   ``pmap``, ``shard_map``, ``grad``, ``value_and_grad``, or a
   ``functools.partial`` of one) — ``obs.traced`` is a span decorator,
   not a transform, and deliberately does NOT count;
2. its name is passed as the first positional argument to a tracing
   wrapper call anywhere in the scanned tree (``jax.vmap(f)``,
   ``lax.scan(body, ...)``, ``shard_map(body, mesh, ...)``);
3. it is defined lexically inside a traced function; or
4. it has at least one known intra-repo call site and *all* of them are
   in traced functions (fixpoint over a simple-name call graph).

Everything else — including module-level statements — is eager.  The
call graph matches callees by simple name across the whole scanned tree,
which is deliberately coarse: a merge across same-named functions can
only make code *look* traced, i.e. relax REPRO001 (missed finding, safe
direction) rather than invent one.

Copy of ``repro.analysis.scopes``.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

# Final attribute name of a call/decorator that puts its operand under a
# JAX trace.  ``scan`` covers ``lax.scan``; ``traced`` (repro.obs) is
# intentionally absent.
TRACE_WRAPPERS = {
    "jit", "vmap", "pmap", "shard_map", "scan", "grad", "value_and_grad",
}

FuncNode = (ast.FunctionDef, ast.AsyncFunctionDef)


def final_name(node: ast.AST) -> Optional[str]:
    """`jax.lax.scan` -> 'scan', `jit` -> 'jit', else None."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def dotted_parts(node: ast.AST) -> List[str]:
    """`tr.eng.clock` -> ['tr', 'eng', 'clock'] (best effort)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return list(reversed(parts))


def _is_trace_wrapper(func: ast.AST) -> bool:
    """True when ``func`` names a tracing transform, unwrapping
    ``functools.partial(jax.jit, ...)``."""
    name = final_name(func)
    if name in TRACE_WRAPPERS:
        return True
    if isinstance(func, ast.Call) and final_name(func.func) == "partial":
        return bool(func.args) and final_name(func.args[0]) in TRACE_WRAPPERS
    return False


def _decorated_traced(node) -> bool:
    for dec in node.decorator_list:
        if _is_trace_wrapper(dec):
            return True
        # @partial(jax.jit, static_argnums=...) / @jit(...) as a call
        if isinstance(dec, ast.Call) and _is_trace_wrapper(dec):
            return True
        if isinstance(dec, ast.Call) and final_name(dec.func) in TRACE_WRAPPERS:
            return True
    return False


@dataclass
class FunctionInfo:
    """One function def, keyed by node identity across passes."""
    node: object
    module: str                      # repo-relative path of the file
    simple_name: str
    qualname: str
    parent: Optional["FunctionInfo"]
    decorated_traced: bool
    callees: Set[str] = field(default_factory=set)
    traced: bool = False


class RepoScopes:
    """Cross-file scope index; build once, query from every rule."""

    def __init__(self):
        self._by_node: Dict[int, FunctionInfo] = {}
        self._functions: List[FunctionInfo] = []
        self._wrapped_names: Set[str] = set()
        # simple name -> infos of every function with that name
        self._by_simple: Dict[str, List[FunctionInfo]] = {}

    # ---- pass 1: per-file collection ----------------------------------

    def add_file(self, module: str, tree: ast.Module):
        self._collect(module, tree, parent=None, prefix="")
        for call in ast.walk(tree):
            if (isinstance(call, ast.Call) and _is_trace_wrapper(call.func)
                    and call.args):
                first = call.args[0]
                name = final_name(first)
                if name is not None:
                    self._wrapped_names.add(name)

    def _collect(self, module: str, node: ast.AST,
                 parent: Optional[FunctionInfo], prefix: str):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, FuncNode):
                qual = f"{prefix}{child.name}"
                info = FunctionInfo(
                    node=child, module=module, simple_name=child.name,
                    qualname=qual, parent=parent,
                    decorated_traced=_decorated_traced(child))
                info.callees = self._own_calls(child)
                self._by_node[id(child)] = info
                self._functions.append(info)
                self._by_simple.setdefault(child.name, []).append(info)
                self._collect(module, child, info, prefix=qual + ".")
            elif isinstance(child, ast.ClassDef):
                self._collect(module, child, parent,
                              prefix=f"{prefix}{child.name}.")
            else:
                self._collect(module, child, parent, prefix=prefix)

    @staticmethod
    def _own_calls(func) -> Set[str]:
        """Simple names called directly in ``func``'s body, excluding
        nested function bodies (those get their own FunctionInfo)."""
        out: Set[str] = set()

        def walk(node):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, FuncNode):
                    continue
                if isinstance(child, ast.Call):
                    name = final_name(child.func)
                    if name:
                        out.add(name)
                walk(child)

        walk(func)
        return out

    # ---- pass 2: propagation ------------------------------------------

    def resolve(self):
        for info in self._functions:
            info.traced = (info.decorated_traced
                           or info.simple_name in self._wrapped_names)
        # lexical nesting under a traced def
        changed = True
        while changed:
            changed = False
            for info in self._functions:
                if not info.traced and info.parent and info.parent.traced:
                    info.traced = True
                    changed = True
            # all-call-sites-traced fixpoint
            for info in self._functions:
                if info.traced:
                    continue
                sites = [f for f in self._functions
                         if info.simple_name in f.callees]
                if sites and all(s.traced for s in sites):
                    info.traced = True
                    changed = True

    # ---- queries -------------------------------------------------------

    def info(self, func_node) -> Optional[FunctionInfo]:
        return self._by_node.get(id(func_node))

    def is_traced(self, func_node) -> bool:
        info = self._by_node.get(id(func_node))
        return bool(info and info.traced)
