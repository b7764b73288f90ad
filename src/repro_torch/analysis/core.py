"""repro_torch.analysis core: findings, suppression, and the project
model (the reference's ``repro.analysis.core``, its logic unchanged).

The analyzer is pure-AST: it never imports the code under analysis (so it
runs in milliseconds, with no torch import, on any checkout).  A run builds
a ``Project`` from the target tree, gives every registered rule the whole
project (rules are free to do cross-file work — duplicate registrations,
lock-order graphs), filters the findings through inline suppressions, and
diffs the survivors against the committed baseline.

Inline suppression::

    self._t0 = time.perf_counter()   # nk: allow[NK02]: deliberate wall site

``# nk: allow[NK01,NK02]`` on the finding's line (or alone on the line
directly above it) suppresses those rules there.  Suppressions are for
*deliberate, explained* exceptions; wholesale acceptance of legacy
findings belongs in the baseline (``repro_torch.analysis.baseline``) so new
code starts clean.
"""
from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

SEVERITIES = ("error", "warning", "info")

_ALLOW_RE = re.compile(r"#\s*nk:\s*allow\[([A-Za-z0-9_,\s]+)\]")


@dataclass(frozen=True)
class Finding:
    """One rule violation at a source location."""
    rule: str                 # "NK02"
    severity: str             # error | warning | info
    path: str                 # repo-relative, forward slashes
    line: int                 # 1-based
    message: str
    context: str = ""         # stripped source line (baseline identity)

    def key(self) -> Tuple[str, str, str]:
        """Baseline identity: line numbers drift, code lines rarely do."""
        return (self.path, self.rule, self.context)

    def render(self) -> str:
        return (f"{self.path}:{self.line}: {self.rule} [{self.severity}] "
                f"{self.message}")


class Module:
    """One parsed source file plus its comment-derived annotations."""

    def __init__(self, path: str, source: str):
        self.path = path.replace("\\", "/")
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        # line -> set of rule ids allowed there (line itself or line above)
        self._allows: Dict[int, set] = {}
        for i, text in enumerate(self.lines, start=1):
            m = _ALLOW_RE.search(text)
            if m:
                rules = {r.strip().upper() for r in m.group(1).split(",")
                         if r.strip()}
                self._allows.setdefault(i, set()).update(rules)
                # a standalone allow-comment covers the next line too
                if text.lstrip().startswith("#"):
                    self._allows.setdefault(i + 1, set()).update(rules)

    @property
    def name(self) -> str:
        """Dotted module name, best-effort ("repro_torch.core.pool")."""
        p = self.path
        for root in ("src/", "/src/"):
            idx = p.find(root)
            if idx >= 0:
                p = p[idx + len(root):]
                break
        p = re.sub(r"\.py$", "", p)
        p = re.sub(r"/__init__$", "", p)
        return p.replace("/", ".")

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""

    def allowed(self, rule: str, lineno: int) -> bool:
        return rule in self._allows.get(lineno, ())

    def comment_on(self, lineno: int) -> str:
        """The trailing comment of a source line ('' if none)."""
        text = self.line_text(lineno)
        idx = text.find("#")
        return text[idx:] if idx >= 0 else ""

    def finding(self, rule: "Rule", node_or_line, message: str,
                severity: Optional[str] = None) -> Finding:
        line = node_or_line if isinstance(node_or_line, int) \
            else node_or_line.lineno
        return Finding(rule=rule.id, severity=severity or rule.severity,
                       path=self.path, line=line, message=message,
                       context=self.line_text(line))


class Project:
    """Every module under analysis, indexed for cross-file rules."""

    def __init__(self, modules: List[Module]):
        self.modules = modules
        self.by_name: Dict[str, Module] = {m.name: m for m in modules}
        self.by_path: Dict[str, Module] = {m.path: m for m in modules}

    @classmethod
    def from_paths(cls, paths: Iterable[str],
                   rel_to: Optional[str] = None) -> "Project":
        modules: List[Module] = []
        errors: List[str] = []
        for raw in paths:
            p = Path(raw)
            files = sorted(p.rglob("*.py")) if p.is_dir() else [p]
            for f in files:
                rel = f
                if rel_to is not None:
                    try:
                        rel = f.resolve().relative_to(Path(rel_to).resolve())
                    except ValueError:
                        rel = f
                try:
                    modules.append(Module(str(rel), f.read_text()))
                except SyntaxError as e:
                    errors.append(f"{rel}: {e}")
        if errors:
            raise SyntaxError("unparseable sources:\n" + "\n".join(errors))
        return cls(modules)

    @classmethod
    def from_sources(cls, sources: Dict[str, str]) -> "Project":
        """Test/fixture entry point: {path: source} in memory."""
        return cls([Module(p, s) for p, s in sources.items()])


class Rule:
    """One pluggable check.  Subclasses set ``id``/``title``/``severity``
    and implement ``run(project)`` yielding raw findings (suppression and
    baseline filtering happen in the driver)."""

    id: str = "NK00"
    title: str = "?"
    severity: str = "error"

    def run(self, project: Project) -> Iterator[Finding]:
        raise NotImplementedError


def all_rules() -> List[Rule]:
    """The shipped rule set, in id order."""
    from repro_torch.analysis.nk01_locks import LockDisciplineRule
    from repro_torch.analysis.nk02_clock import ClockDisciplineRule
    from repro_torch.analysis.nk03_host_sync import HostSyncRule
    from repro_torch.analysis.nk04_registry import RegistryHygieneRule
    return [LockDisciplineRule(), ClockDisciplineRule(),
            HostSyncRule(), RegistryHygieneRule()]


def run_rules(project: Project,
              rules: Optional[Iterable[Rule]] = None) -> List[Finding]:
    """All non-suppressed findings, ordered by (path, line, rule)."""
    rules = list(rules) if rules is not None else all_rules()
    out: List[Finding] = []
    for rule in rules:
        for f in rule.run(project):
            mod = project.by_path.get(f.path)
            if mod is not None and mod.allowed(f.rule, f.line):
                continue
            out.append(f)
    out.sort(key=lambda f: (f.path, f.line, f.rule))
    return out


# -- shared AST helpers ------------------------------------------------------

def dotted_name(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for Name/Attribute chains, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def decorator_call(dec: ast.AST) -> Tuple[Optional[str], List[ast.expr],
                                          List[ast.keyword]]:
    """(dotted name, args, keywords) of a decorator; bare names have no
    args.  ``@mod.deco(x)`` -> ("mod.deco", [x], [])."""
    if isinstance(dec, ast.Call):
        return dotted_name(dec.func), list(dec.args), list(dec.keywords)
    return dotted_name(dec), [], []


def import_aliases(tree: ast.AST) -> Dict[str, str]:
    """Local alias -> dotted module/object it refers to.

    Covers ``import a.b as c`` and ``from a.b import c [as d]`` — enough
    to resolve ``_fa.flash_attention``-style cross-module calls.
    """
    out: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                out[a.asname or a.name.split(".")[0]] = \
                    a.name if a.asname else a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            for a in node.names:
                out[a.asname or a.name] = f"{node.module}.{a.name}"
    return out
