"""REPRO007 — broad exception handlers that swallow bugs.

A bare ``except:`` or ``except Exception:`` around simulator code turns
a determinism bug (shape mismatch, missing attribute, tracer leak) into
a silently-different result — the exact failure mode the parity tests
exist to catch loudly.  Handlers that re-raise (``raise`` anywhere in
the body) keep the loud path and are exempt; everything else must name
the exception types it actually expects or justify the catch-all.

Copy of ``repro.analysis.rules.repro007_broad_except``.
"""

from __future__ import annotations

import ast

from ..core import FileContext, Rule, register


def _is_broad(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:
        return True
    if isinstance(t, ast.Name) and t.id in {"Exception", "BaseException"}:
        return True
    if isinstance(t, ast.Tuple):
        return any(isinstance(e, ast.Name)
                   and e.id in {"Exception", "BaseException"}
                   for e in t.elts)
    return False


def _reraises(handler: ast.ExceptHandler) -> bool:
    return any(isinstance(n, ast.Raise) for n in ast.walk(handler))


@register
class BroadExcept(Rule):
    id = "REPRO007"
    name = "broad-except-swallows-bugs"

    def check_file(self, ctx: FileContext):
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if _is_broad(node) and not _reraises(node):
                what = ("bare `except:`" if node.type is None
                        else "`except Exception`")
                ctx.add(node, self.id,
                        f"{what} swallows unexpected failures — name the "
                        "exception types this site actually expects, or "
                        "re-raise with context")
