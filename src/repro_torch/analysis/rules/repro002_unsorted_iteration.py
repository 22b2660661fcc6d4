"""REPRO002 — unsorted dict/set iteration feeding order-sensitive state.

The engine and runner are deterministic only because every hash-ordered
container on an order-critical path remembered to ``sorted(...)`` first
(``experiments/runner.py`` bucket packing and spec ordering are the
canonical survivors).  Dict insertion order is deterministic *within*
one process, but sets are salted per process, and both silently reorder
when someone refactors the insertion site — so any iteration over a
``.keys()/.values()/.items()`` view, a ``set(...)``, or a set literal
whose loop body consumes RNG, pushes events, or packs buckets must be
wrapped in ``sorted(...)`` or justified.

Copy of ``repro.analysis.rules.repro002_unsorted_iteration``.
"""

from __future__ import annotations

import ast

from ..core import FileContext, Rule, register
from ..scopes import dotted_parts, final_name

# attribute calls inside the loop body that make order observable
SINK_METHODS = {"push", "requeue", "select", "choice", "shuffle",
                "permutation", "integers", "normal", "uniform",
                "standard_normal"}
# plain function calls with the same property (repo-specific order sinks)
SINK_FUNCS = {"materialize_streams", "client_batches", "bucket_by_steps",
              "select_clients"}


def _iterates_hash_order(it: ast.AST) -> bool:
    """True for d.keys()/.values()/.items(), set(...), or a set literal
    — NOT when already wrapped in sorted(...)."""
    if isinstance(it, ast.Call):
        name = final_name(it.func)
        if name in {"keys", "values", "items"} \
                and isinstance(it.func, ast.Attribute):
            return True
        if name == "set":
            return True
    return isinstance(it, (ast.Set, ast.SetComp))


def _body_has_order_sink(body) -> bool:
    for stmt in body:
        for node in ast.walk(stmt):
            if isinstance(node, ast.Call):
                name = final_name(node.func)
                if isinstance(node.func, ast.Attribute) \
                        and name in SINK_METHODS:
                    return True
                if name in SINK_FUNCS:
                    return True
            # any touch of an rng object counts as RNG consumption
            if isinstance(node, (ast.Name, ast.Attribute)):
                if any("rng" in p.lower().split("_") or p == "rng"
                       for p in dotted_parts(node)):
                    return True
    return False


@register
class UnsortedIteration(Rule):
    id = "REPRO002"
    name = "unsorted-order-sensitive-iteration"

    def check_file(self, ctx: FileContext):
        for node in ast.walk(ctx.tree):
            if not isinstance(node, (ast.For, ast.AsyncFor)):
                continue
            if not _iterates_hash_order(node.iter):
                continue
            if not _body_has_order_sink(node.body):
                continue
            what = ("set" if isinstance(node.iter, (ast.Set, ast.SetComp))
                    or (isinstance(node.iter, ast.Call)
                        and final_name(node.iter.func) == "set")
                    else "dict view")
            ctx.add(node, self.id,
                    f"iteration over an unsorted {what} feeds an "
                    "order-sensitive operation (RNG/event-queue/bucket "
                    "packing) — wrap the iterable in sorted(...)")
