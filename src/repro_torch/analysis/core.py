"""Analyzer core: findings, the rule registry, noqa handling, the file walk.

Design notes
------------
* One parse per file; the same ``ast`` tree object is shared between the
  jit-scope pass ([`scopes`](scopes.py)) and every rule, so scope lookups
  key on node identity.
* Findings are value objects sorted by ``(path, line, col, rule,
  message)`` — the reporters emit them in exactly that order, which is
  what makes two runs byte-identical.
* Suppression is ``# noqa: REPRO0xx -- justification``.  A noqa without
  the ``-- justification`` tail does NOT suppress: the finding is kept
  and annotated, so an empty excuse can't sneak past the ratchet.  The
  comment must sit on the finding's line or within the flagged
  statement's header span (multi-line calls anchor on any of their own
  lines; compound statements anchor on the header only, never on body
  lines).

Copy of ``repro.analysis.core``; reported paths anchor at
``src/repro_torch``.
"""

from __future__ import annotations

import ast
import re
import tokenize
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

from .scopes import FuncNode, RepoScopes

_NOQA_RE = re.compile(
    r"#\s*noqa:\s*(?P<codes>REPRO\d{3}(?:\s*,\s*REPRO\d{3})*)"
    r"(?:\s*--\s*(?P<why>\S.*))?")


@dataclass(frozen=True)
class Finding:
    path: str        # posix path as reported (stable across runs)
    line: int
    col: int
    rule: str
    message: str

    def sort_key(self):
        return (self.path, self.line, self.col, self.rule, self.message)

    def to_dict(self) -> dict:
        return {"path": self.path, "line": self.line, "col": self.col,
                "rule": self.rule, "message": self.message}

    # Baseline identity deliberately omits line/col so a pure line-shift
    # upstream of an accepted finding doesn't count as "new".
    def baseline_key(self) -> Tuple[str, str, str]:
        return (self.path, self.rule, self.message)


@dataclass(frozen=True)
class Suppression:
    finding: Finding
    justification: str


class RuleError(Exception):
    """Internal analyzer failure (exit code 2 territory)."""


_REGISTRY: Dict[str, "Rule"] = {}


def register(cls):
    """Class decorator: instantiate and index a rule by its id."""
    rule = cls()
    if rule.id in _REGISTRY:
        raise RuleError(f"duplicate rule id {rule.id}")
    _REGISTRY[rule.id] = rule
    return cls


def all_rules() -> List["Rule"]:
    # import for side effect: each module registers its rule(s)
    from . import rules as _rules  # noqa: F401 (registration import)
    return [_REGISTRY[k] for k in sorted(_REGISTRY)]


class Rule:
    """Base rule: subclasses set ``id``/``name`` and walk ``ctx.tree``."""

    id = "REPRO000"
    name = "base"

    def check_file(self, ctx: "FileContext") -> None:
        raise NotImplementedError


class FileContext:
    """Everything a rule needs about one file, plus the finding sink."""

    def __init__(self, path: Path, rel: str, source: str, tree: ast.Module,
                 scopes: RepoScopes):
        self.path = path
        self.rel = rel              # reported path (posix)
        self.source = source
        self.tree = tree
        self.scopes = scopes
        self.raw: List[Tuple[Finding, Tuple[int, int]]] = []
        self._parents: Dict[int, ast.AST] = {}
        for parent in ast.walk(tree):
            for child in ast.iter_child_nodes(parent):
                self._parents[id(child)] = parent

    # ---- tree navigation ----------------------------------------------

    def parent(self, node: ast.AST) -> Optional[ast.AST]:
        return self._parents.get(id(node))

    def ancestors(self, node: ast.AST):
        cur = self.parent(node)
        while cur is not None:
            yield cur
            cur = self.parent(cur)

    def enclosing_function(self, node: ast.AST):
        for anc in self.ancestors(node):
            if isinstance(anc, FuncNode):
                return anc
        return None

    def in_traced_scope(self, node: ast.AST) -> bool:
        fn = self.enclosing_function(node)
        return fn is not None and self.scopes.is_traced(fn)

    def enclosing_loop(self, node: ast.AST):
        """Nearest For/While above ``node`` without crossing a def."""
        for anc in self.ancestors(node):
            if isinstance(anc, (ast.For, ast.While)):
                return anc
            if isinstance(anc, FuncNode):
                return None
        return None

    # ---- findings ------------------------------------------------------

    def add(self, node: ast.AST, rule: str, message: str):
        """Report ``rule`` at ``node``; noqa may sit on any line of the
        node's own span — capped at the header for compound statements so
        a comment deep inside a loop body can't silence the loop."""
        line = getattr(node, "lineno", 1)
        end = getattr(node, "end_lineno", line) or line
        body = getattr(node, "body", None)
        if isinstance(body, list) and body and hasattr(body[0], "lineno"):
            end = max(line, body[0].lineno - 1)
        col = getattr(node, "col_offset", 0)
        finding = Finding(path=self.rel, line=line, col=col, rule=rule,
                          message=message)
        self.raw.append((finding, (line, end)))


def parse_noqa(source: str) -> Dict[int, Dict[str, Optional[str]]]:
    """line -> {code: justification-or-None} from real COMMENT tokens
    (a '# noqa:' inside a string literal is not a suppression)."""
    out: Dict[int, Dict[str, Optional[str]]] = {}
    lines = source.splitlines(keepends=True)
    try:
        tokens = list(tokenize.generate_tokens(iter(lines).__next__))
    except (tokenize.TokenError, IndentationError, SyntaxError):
        return out
    for tok in tokens:
        if tok.type != tokenize.COMMENT:
            continue
        m = _NOQA_RE.search(tok.string)
        if not m:
            continue
        why = m.group("why")
        codes = [c.strip() for c in m.group("codes").split(",")]
        entry = out.setdefault(tok.start[0], {})
        for code in codes:
            entry[code] = why.strip() if why else None
    return out


@dataclass
class FileResult:
    findings: List[Finding]
    suppressed: List[Suppression]


def apply_noqa(ctx: FileContext) -> FileResult:
    noqa = parse_noqa(ctx.source)
    findings: List[Finding] = []
    suppressed: List[Suppression] = []
    for finding, (start, end) in ctx.raw:
        verdict: Optional[Suppression] = None
        unjustified = False
        for line in range(start, end + 1):
            entry = noqa.get(line)
            if not entry or finding.rule not in entry:
                continue
            why = entry[finding.rule]
            if why:
                verdict = Suppression(finding, why)
                break
            unjustified = True
        if verdict is not None:
            suppressed.append(verdict)
        elif unjustified:
            findings.append(Finding(
                path=finding.path, line=finding.line, col=finding.col,
                rule=finding.rule,
                message=finding.message
                + " [noqa without '-- justification' — not suppressed]"))
        else:
            findings.append(finding)
    return FileResult(findings, suppressed)


# ---- file walk ---------------------------------------------------------


@dataclass
class AnalysisResult:
    findings: List[Finding]
    suppressed: List[Suppression]
    errors: List[str]           # unparsable files etc -> exit 2
    n_files: int = 0


def iter_py_files(paths: Iterable[Path]) -> List[Path]:
    out = []
    for p in paths:
        if p.is_dir():
            out.extend(q for q in p.rglob("*.py") if q.is_file())
        elif p.suffix == ".py":
            out.append(p)
    return sorted(set(out))


def report_path(file: Path, root: Path) -> str:
    """Stable reported path: anchored at ``src/`` when the file lives in
    the port's src-layout tree (so cwd doesn't leak into reports), else relative
    to the scan root."""
    resolved = file.resolve()
    parts = resolved.parts
    for i in range(len(parts) - 1, 0, -1):
        if parts[i - 1] == "src" and parts[i] == "repro_torch":
            return "/".join(parts[i - 1:])
    try:
        return resolved.relative_to(root.resolve()).as_posix()
    except ValueError:
        return file.as_posix()


def analyze_paths(paths: List[Path]) -> AnalysisResult:
    files = iter_py_files(paths)
    root = paths[0] if paths and paths[0].is_dir() else Path(".")
    scopes = RepoScopes()
    contexts: List[FileContext] = []
    errors: List[str] = []
    for file in files:
        rel = report_path(file, root)
        try:
            source = file.read_text(encoding="utf-8")
            tree = ast.parse(source, filename=str(file))
        except (SyntaxError, UnicodeDecodeError, OSError) as e:
            errors.append(f"{rel}: {type(e).__name__}: {e}")
            continue
        scopes.add_file(rel, tree)
        contexts.append(FileContext(file, rel, source, tree, scopes))
    scopes.resolve()

    findings: List[Finding] = []
    suppressed: List[Suppression] = []
    rules = all_rules()
    for ctx in contexts:
        for rule in rules:
            rule.check_file(ctx)
        res = apply_noqa(ctx)
        findings.extend(res.findings)
        suppressed.extend(res.suppressed)
    findings.sort(key=Finding.sort_key)
    suppressed.sort(key=lambda s: s.finding.sort_key())
    return AnalysisResult(findings=findings, suppressed=suppressed,
                          errors=sorted(errors), n_files=len(files))
