"""Checker registry, findings, suppressions, and the file walker.

Port of ``repro.lint.core``, with its own registry: the port's checkers
register here and nowhere else.  A *checker* is a function
``check(mod: ModuleSource) -> Iterable[Finding]`` registered with
:func:`register_checker` together with the rules it can emit.  The
runner parses each ``.py`` file once, hands the shared
:class:`ModuleSource` to every checker, then filters the findings
through the suppression comments before reporting.

Rule IDs are stable (``RPL102`` ...) and each rule also has a slug
(``inplace-carry``); suppressions accept either form.  The suppression
syntax is the JAX package's, so one comment reads the same under both
linters: ``# repro-lint: disable=<id|slug>[,...]`` at the end of a line,
``# repro-lint: disable-file=<id|slug>`` anywhere in a file, ``all`` for
every rule.
"""
from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Sequence, Tuple


@dataclass(frozen=True)
class Rule:
    """One diagnostic: stable ID, short slug, one-line description."""
    id: str                 # e.g. "RPL302", never renumbered
    slug: str               # e.g. "host-sync", the suppression alias
    summary: str


@dataclass(frozen=True)
class Finding:
    path: str
    line: int
    col: int
    rule: Rule
    message: str

    def format(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: "
                f"{self.rule.id}[{self.rule.slug}] {self.message}")

    def to_json(self) -> dict:
        return {"path": self.path, "line": self.line, "col": self.col,
                "rule": self.rule.id, "slug": self.rule.slug,
                "message": self.message}


@dataclass
class ModuleSource:
    """One parsed source file, shared by every checker."""
    path: Path
    text: str
    tree: ast.Module
    lines: List[str] = field(default_factory=list)

    def __post_init__(self):
        if not self.lines:
            self.lines = self.text.splitlines()

    def finding(self, rule: Rule, node, message: str) -> Finding:
        return Finding(path=str(self.path),
                       line=getattr(node, "lineno", 1),
                       col=getattr(node, "col_offset", 0),
                       rule=rule, message=message)


SYNTAX_ERROR = Rule("RPL000", "syntax-error", "file does not parse")

_CHECKERS: List[Tuple[str, Callable[[ModuleSource], Iterable[Finding]]]] = []
_RULES: Dict[str, Rule] = {}


def register_checker(name: str, rules: Sequence[Rule]):
    """Decorator: register ``check(mod) -> findings`` under ``name``,
    declaring the rules it may emit (IDs unique across checkers)."""

    def deco(fn):
        for r in rules:
            prev = _RULES.get(r.id)
            if prev is not None and prev != r:
                raise ValueError(f"rule id {r.id} registered twice")
            _RULES[r.id] = r
        _CHECKERS.append((name, fn))
        return fn

    return deco


def _load_builtin_checkers():
    # imported for its side effect: each checker module registers itself
    from repro_torch.lint import checkers  # noqa: F401


def all_rules() -> Tuple[Rule, ...]:
    """The rule table, sorted by ID."""
    _load_builtin_checkers()
    return tuple(sorted(_RULES.values(), key=lambda r: r.id))


_SUPPRESS_RE = re.compile(
    r"#\s*repro-lint:\s*(disable(?:-file)?)\s*=\s*([A-Za-z0-9_,\s-]+)")


def _suppressions(mod: ModuleSource):
    """(per-line {lineno: tokens}, file-wide tokens)."""
    per_line: Dict[int, set] = {}
    whole_file: set = set()
    for i, line in enumerate(mod.lines, start=1):
        if "repro-lint" not in line:
            continue
        for m in _SUPPRESS_RE.finditer(line):
            tokens = {t.strip().lower() for t in m.group(2).split(",")
                      if t.strip()}
            if m.group(1) == "disable-file":
                whole_file |= tokens
            else:
                per_line.setdefault(i, set()).update(tokens)
    return per_line, whole_file


def _suppressed(f: Finding, per_line, whole_file) -> bool:
    keys = {"all", f.rule.id.lower(), f.rule.slug.lower()}
    return bool(whole_file & keys) or bool(per_line.get(f.line, set()) & keys)


def lint_file(path) -> List[Finding]:
    """Every registered checker over one file, after suppressions,
    sorted and without duplicates."""
    _load_builtin_checkers()
    path = Path(path)
    text = path.read_text()
    try:
        tree = ast.parse(text, filename=str(path))
    except SyntaxError as e:
        return [Finding(str(path), e.lineno or 1, e.offset or 0,
                        SYNTAX_ERROR, f"syntax error: {e.msg}")]
    mod = ModuleSource(path=path, text=text, tree=tree)
    per_line, whole_file = _suppressions(mod)
    found: List[Finding] = []
    for _, fn in _CHECKERS:
        found.extend(fn(mod))
    # one site reached along two paths is one finding (distinct messages
    # at one site stay distinct)
    unique = {(f.path, f.line, f.col, f.rule.id, f.message): f
              for f in found if not _suppressed(f, per_line, whole_file)}
    return [unique[k] for k in sorted(unique)]


def iter_py_files(paths: Sequence) -> List[Path]:
    """The ``.py`` files among ``paths`` and under its directories."""
    files: List[Path] = []
    for p in map(Path, paths):
        if p.is_file() and p.suffix == ".py":
            files.append(p)
        elif p.is_dir():
            files.extend(sorted(q for q in p.rglob("*.py")
                                if "__pycache__" not in q.parts))
    return files


def lint_paths(paths: Sequence) -> List[Finding]:
    """Lint every ``.py`` file under ``paths`` (files or directories)."""
    return [f for path in iter_py_files(paths) for f in lint_file(path)]
