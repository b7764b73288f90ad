"""NK01 — lock discipline.

The switch window is sub-millisecond: a torn read between
``PipelinePool.activate`` (the pointer swap) and the serving loop's
admission path silently corrupts the downtime numbers this repo exists to
reproduce.  So classes declare their concurrency contract
(``@guarded_by("_lock", attrs...)`` from ``repro_torch.core.concurrency``, or a
``# guarded-by: _lock`` trailing comment on the attribute's first
assignment) and this rule enforces it statically:

* **guarded access** — every ``self.<attr>`` read/write of a declared
  attribute must sit lexically inside ``with self.<lock>`` (or an
  ``aliases=`` condition wrapping the same lock).  ``__init__`` and the
  decorator's ``init_methods`` are exempt (pre-publication), as is any
  method whose ``def`` line carries ``# holds: <lock>`` (a documented
  called-with-lock-held helper).  Nested functions reset the held state:
  a closure outlives the ``with`` block it was defined in.
* **foreign private access** — ``other._attr`` where ``_attr`` is a
  *private* guarded attribute of a known class is flagged anywhere: no
  amount of local locking makes poking another object's guarded state
  safe; go through an accessor that takes that object's lock.
* **acquisition order** — locks carry a ``rank``; lexically nested
  ``with`` blocks must acquire strictly increasing ranks, or the
  lock-order contract (and its runtime twin, ``DebugLock``) is violated.
"""
from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Set, Tuple

from repro_torch.analysis.core import (Finding, Module, Project, Rule,
                                       decorator_call)

_GUARDED_COMMENT_RE = re.compile(r"#\s*guarded-by:\s*([A-Za-z_]\w*)")
_HOLDS_RE = re.compile(r"#\s*holds:\s*([A-Za-z_]\w*)")


@dataclass
class LockSpec:
    lock: str
    attrs: Set[str] = field(default_factory=set)
    rank: Optional[int] = None
    aliases: Tuple[str, ...] = ()
    init_methods: Tuple[str, ...] = ()

    def names(self) -> Set[str]:
        return {self.lock, *self.aliases}


@dataclass
class ClassInfo:
    module: Module
    node: ast.ClassDef
    specs: List[LockSpec]
    bases: List[str]

    def spec_for(self, attr: str) -> Optional[LockSpec]:
        for s in self.specs:
            if attr in s.attrs:
                return s
        return None

    def lock_rank(self, lock_name: str) -> Optional[int]:
        for s in self.specs:
            if lock_name in s.names():
                return s.rank
        return None


def _literal_str(node: ast.expr) -> Optional[str]:
    return node.value if isinstance(node, ast.Constant) \
        and isinstance(node.value, str) else None


def _literal_strs(node: ast.expr) -> Tuple[str, ...]:
    if isinstance(node, (ast.Tuple, ast.List)):
        return tuple(s for e in node.elts
                     if (s := _literal_str(e)) is not None)
    s = _literal_str(node)
    return (s,) if s is not None else ()


def _parse_guarded_decorators(cls: ast.ClassDef) -> List[LockSpec]:
    specs: List[LockSpec] = []
    for dec in cls.decorator_list:
        name, args, kwargs = decorator_call(dec)
        if name is None or name.split(".")[-1] != "guarded_by" or not args:
            continue
        lock = _literal_str(args[0])
        if lock is None:
            continue
        spec = LockSpec(lock=lock,
                        attrs={s for a in args[1:]
                               if (s := _literal_str(a)) is not None})
        for kw in kwargs:
            if kw.arg == "rank" and isinstance(kw.value, ast.Constant) \
                    and isinstance(kw.value.value, int):
                spec.rank = kw.value.value
            elif kw.arg == "aliases":
                spec.aliases = _literal_strs(kw.value)
            elif kw.arg == "init_methods":
                spec.init_methods = _literal_strs(kw.value)
        specs.append(spec)
    return specs


def _comment_guarded_attrs(module: Module,
                           cls: ast.ClassDef) -> Dict[str, str]:
    """attr -> lock from ``self.x = ...  # guarded-by: _lock`` comments."""
    out: Dict[str, str] = {}
    for node in ast.walk(cls):
        if not isinstance(node, (ast.Assign, ast.AnnAssign)):
            continue
        m = _GUARDED_COMMENT_RE.search(module.comment_on(node.lineno))
        if not m:
            continue
        targets = node.targets if isinstance(node, ast.Assign) \
            else [node.target]
        for t in targets:
            if isinstance(t, ast.Attribute) and \
                    isinstance(t.value, ast.Name) and t.value.id == "self":
                out[t.attr] = m.group(1)
    return out


def _collect_classes(project: Project) -> Dict[str, ClassInfo]:
    """class name -> info, for every class with any guarded declaration."""
    out: Dict[str, ClassInfo] = {}
    for module in project.modules:
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            specs = _parse_guarded_decorators(node)
            for attr, lock in _comment_guarded_attrs(module, node).items():
                for s in specs:
                    if s.lock == lock:
                        s.attrs.add(attr)
                        break
                else:
                    specs.append(LockSpec(lock=lock, attrs={attr}))
            bases = [b.id for b in node.bases if isinstance(b, ast.Name)]
            if specs or any(b in out for b in bases):
                out[node.name] = ClassInfo(module, node, specs, bases)
    # merge base-class specs into subclasses (one level is enough for a
    # pool hierarchy; iterate to close deeper chains)
    for _ in range(3):
        for info in out.values():
            for b in info.bases:
                base = out.get(b)
                if base is None:
                    continue
                for bs in base.specs:
                    mine = next((s for s in info.specs
                                 if s.lock == bs.lock), None)
                    if mine is None:
                        info.specs.append(LockSpec(
                            bs.lock, set(bs.attrs), bs.rank,
                            bs.aliases, bs.init_methods))
                    else:
                        mine.attrs |= bs.attrs
                        if mine.rank is None:
                            mine.rank = bs.rank
                        mine.aliases = tuple({*mine.aliases, *bs.aliases})
    return out


class _MethodChecker(ast.NodeVisitor):
    """Walks one method body tracking which self-locks are lexically held."""

    def __init__(self, rule: "LockDisciplineRule", module: Module,
                 info: ClassInfo, findings: List[Finding]):
        self.rule = rule
        self.module = module
        self.info = info
        self.findings = findings
        self.held: List[str] = []      # lock names (canonical, not aliases)

    def _canonical(self, name: str) -> Optional[str]:
        for s in self.info.specs:
            if name in s.names():
                return s.lock
        return None

    def visit_With(self, node: ast.With) -> None:
        entered: List[str] = []
        for item in node.items:
            ctx = item.context_expr
            if isinstance(ctx, ast.Attribute) and \
                    isinstance(ctx.value, ast.Name) and ctx.value.id == "self":
                lock = self._canonical(ctx.attr)
                if lock is not None:
                    self._check_order(node, lock)
                    entered.append(lock)
        self.held.extend(entered)
        for stmt in node.body:
            self.visit(stmt)
        for _ in entered:
            self.held.pop()

    def _check_order(self, node: ast.With, lock: str) -> None:
        rank = self.info.lock_rank(lock)
        if rank is None:
            return
        for outer in self.held:
            if outer == lock:
                continue
            outer_rank = self.info.lock_rank(outer)
            if outer_rank is not None and outer_rank >= rank:
                self.findings.append(self.module.finding(
                    self.rule, node,
                    f"lock order inversion: acquires {lock!r} (rank {rank}) "
                    f"inside {outer!r} (rank {outer_rank}); ranks must "
                    f"strictly increase inward"))

    def visit_Attribute(self, node: ast.Attribute) -> None:
        if isinstance(node.value, ast.Name) and node.value.id == "self":
            spec = self.info.spec_for(node.attr)
            if spec is not None and spec.lock not in self.held:
                ctx = "written" if isinstance(node.ctx,
                                              (ast.Store, ast.Del)) else "read"
            # (findings emitted below to keep one exit path)
                self.findings.append(self.module.finding(
                    self.rule, node,
                    f"guarded attribute self.{node.attr} {ctx} outside "
                    f"'with self.{spec.lock}' "
                    f"({self.info.node.name} declares it guarded)"))
        self.generic_visit(node)

    # a closure may run after the enclosing with-block exited: reset the
    # held state inside nested defs/lambdas
    def _visit_nested(self, node) -> None:
        saved, self.held = self.held, []
        for stmt in getattr(node, "body", []) if not isinstance(
                node, ast.Lambda) else [node.body]:
            self.visit(stmt)
        self.held = saved

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._visit_nested(node)

    def visit_AsyncFunctionDef(self, node) -> None:
        self._visit_nested(node)

    def visit_Lambda(self, node: ast.Lambda) -> None:
        self._visit_nested(node)


class LockDisciplineRule(Rule):
    id = "NK01"
    title = "guarded attributes accessed outside their lock"
    severity = "error"

    def run(self, project: Project) -> Iterator[Finding]:
        classes = _collect_classes(project)
        findings: List[Finding] = []
        for info in classes.values():
            if not info.specs:
                continue
            self._check_class(info, findings)
        self._check_foreign_access(project, classes, findings)
        return iter(findings)

    def _check_class(self, info: ClassInfo,
                     findings: List[Finding]) -> None:
        exempt = {"__init__"}
        for s in info.specs:
            exempt.update(s.init_methods)
        for node in info.node.body:
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if node.name in exempt:
                continue
            holds = _HOLDS_RE.search(info.module.comment_on(node.lineno))
            checker = _MethodChecker(self, info.module, info, findings)
            if holds:
                canonical = checker._canonical(holds.group(1))
                if canonical is not None:
                    checker.held.append(canonical)
            for stmt in node.body:
                checker.visit(stmt)

    def _check_foreign_access(self, project: Project,
                              classes: Dict[str, ClassInfo],
                              findings: List[Finding]) -> None:
        """other._attr where _attr is a private guarded attr of a known
        class: flagged everywhere (accessors exist for a reason)."""
        private: Dict[str, str] = {}       # attr -> owning class
        for name, info in classes.items():
            for s in info.specs:
                for a in s.attrs:
                    if a.startswith("_") and not a.startswith("__"):
                        private[a] = name
        if not private:
            return
        for module in project.modules:
            for node in ast.walk(module.tree):
                if not isinstance(node, ast.Attribute):
                    continue
                owner = private.get(node.attr)
                if owner is None:
                    continue
                if isinstance(node.value, ast.Name) and \
                        node.value.id in ("self", "cls"):
                    continue
                # inside the owning class's own module, owner-module code
                # touching its own kind through a local variable is still
                # cross-object; flag it the same way
                findings.append(module.finding(
                    self, node,
                    f"private guarded attribute ._{node.attr.lstrip('_')} of "
                    f"{owner} accessed through a foreign reference; add a "
                    f"locked accessor on {owner} instead",
                    severity="warning"))
