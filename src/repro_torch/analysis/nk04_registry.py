"""NK04 — registry hygiene.

Strategies, repartition policies and arrival processes all flow through
the same ``Registry`` pattern (``repro_torch.core.strategies.Registry``):
classes register under a string name, call sites resolve instances from
``"name(k=2)"`` spec strings.  Registration errors surface at import
time *of the registering module* — which in a lazily-imported package
can be long after the typo was written — and malformed spec literals
surface only when the experiment that uses them finally runs.  This rule
moves both to lint time:

* **duplicate registration** — two ``@register_strategy`` /
  ``@register_policy`` / ``@register_arrival`` decorations (or
  ``REGISTRY.register(...)`` calls) with the same literal name in the
  same family;
* **invalid name** — a registered name that the spec grammar
  (``name`` or ``name(k=v, ...)``) could never refer back to;
* **shadowed ``name`` attribute** — a registered class whose body also
  assigns ``name = "..."``: the decorator already sets ``cls.name``
  from the registration string, so the body literal is redundant at
  best and silently wrong the moment one of the two is renamed;
* **unparseable spec literal** — a string literal passed to
  ``get_strategy`` / ``get_policy`` / ``get_arrival`` / ``parse_spec``
  / ``Registry.resolve`` (or used as the default of a
  ``strategy``/``policy``/``arrival``/``spec`` parameter) that the spec
  grammar rejects.

The grammar is replicated here with ``ast`` (identifier, optional
key=value literal args) rather than imported, keeping the analyzer free
of runtime imports.
"""
from __future__ import annotations

import ast
import re
from typing import Dict, Iterator, List, Optional, Tuple

from repro_torch.analysis.core import (Finding, Module, Project, Rule,
                                       decorator_call, dotted_name)

_SPEC_RE = re.compile(r"^\s*([A-Za-z_]\w*)\s*(?:\((.*)\))?\s*$")
_NAME_RE = re.compile(r"^[A-Za-z_]\w*$")

REGISTER_FUNCS = {
    "register_strategy": "strategy",
    "register_policy": "policy",
    "register_arrival": "arrival",
}
RESOLVE_FUNCS = frozenset({
    "get_strategy", "get_policy", "get_arrival", "parse_spec", "resolve",
})
SPEC_PARAMS = frozenset({"strategy", "policy", "arrival", "spec"})


def spec_error(spec: str) -> Optional[str]:
    """Why ``spec`` fails the ``name(k=v)`` grammar, or None if valid."""
    m = _SPEC_RE.match(spec)
    if not m:
        return "expected 'name' or 'name(k=v, ...)'"
    _, argstr = m.groups()
    if not argstr or not argstr.strip():
        return None
    try:
        call = ast.parse(f"_spec({argstr})", mode="eval").body
    except SyntaxError:
        return f"args {argstr!r} are not valid Python"
    if call.args or any(kw.arg is None for kw in call.keywords):
        return "args must all be key=value"
    try:
        for kw in call.keywords:
            ast.literal_eval(kw.value)
    except ValueError:
        return "arg values must be literals"
    return None


def _body_name_assign(cls: ast.ClassDef) -> Optional[Tuple[int, str]]:
    """(line, value) of a literal ``name = "..."`` in the class body."""
    for stmt in cls.body:
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 and \
                isinstance(stmt.targets[0], ast.Name) and \
                stmt.targets[0].id == "name" and \
                isinstance(stmt.value, ast.Constant) and \
                isinstance(stmt.value.value, str):
            return stmt.lineno, stmt.value.value
    return None


class RegistryHygieneRule(Rule):
    id = "NK04"
    title = "registry registration and spec-string errors"
    severity = "error"

    def run(self, project: Project) -> Iterator[Finding]:
        findings: List[Finding] = []
        # family -> name -> first registration "path:line"
        seen: Dict[str, Dict[str, str]] = {}

        for module in project.modules:
            for node in ast.walk(module.tree):
                if isinstance(node, ast.ClassDef):
                    self._check_class(module, node, seen, findings)
                elif isinstance(node, ast.Call):
                    self._check_resolve_call(module, node, findings)
                elif isinstance(node, (ast.FunctionDef,
                                       ast.AsyncFunctionDef)):
                    self._check_spec_defaults(module, node, findings)
        return iter(findings)

    # -- registrations ---------------------------------------------------

    def _registration(self, dec: ast.AST) -> Optional[Tuple[str, str, int]]:
        """(family, name, line) if ``dec`` is a register decorator."""
        name, args, _ = decorator_call(dec)
        if name is None or not args:
            return None
        last = name.split(".")[-1]
        family = REGISTER_FUNCS.get(last)
        if family is None and last == "register" and "." in name:
            family = name.split(".")[-2].lower()   # STRATEGIES.register(...)
        if family is None:
            return None
        lit = args[0]
        if isinstance(lit, ast.Constant) and isinstance(lit.value, str):
            return family, lit.value, dec.lineno
        return None

    def _check_class(self, module: Module, cls: ast.ClassDef,
                     seen: Dict[str, Dict[str, str]],
                     findings: List[Finding]) -> None:
        for dec in cls.decorator_list:
            reg = self._registration(dec)
            if reg is None:
                continue
            family, reg_name, line = reg
            if not _NAME_RE.match(reg_name):
                findings.append(module.finding(
                    self, line,
                    f"registered {family} name {reg_name!r} is not "
                    f"addressable by the spec grammar (must be an "
                    f"identifier)"))
            first = seen.setdefault(family, {}).get(reg_name)
            if first is not None:
                findings.append(module.finding(
                    self, line,
                    f"duplicate {family} registration {reg_name!r} "
                    f"(first registered at {first}); pick a distinct name "
                    f"or pass override=True deliberately"))
            else:
                seen[family][reg_name] = f"{module.path}:{line}"
            body = _body_name_assign(cls)
            if body is not None:
                body_line, body_name = body
                if body_name != reg_name:
                    findings.append(module.finding(
                        self, body_line,
                        f"class body sets name={body_name!r} but the "
                        f"registry decorator registers {reg_name!r}; the "
                        f"decorator wins at runtime — delete the body "
                        f"assignment"))
                else:
                    findings.append(module.finding(
                        self, body_line,
                        f"redundant name={body_name!r}: the register "
                        f"decorator already sets cls.name from the "
                        f"registration string; delete the body assignment "
                        f"before the two drift apart",
                        severity="warning"))

    # -- spec literals ---------------------------------------------------

    def _check_spec_literal(self, module: Module, node: ast.expr,
                            where: str, findings: List[Finding]) -> None:
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            err = spec_error(node.value)
            if err is not None:
                findings.append(module.finding(
                    self, node,
                    f"unparseable spec string {node.value!r} {where}: {err}"))

    def _check_resolve_call(self, module: Module, call: ast.Call,
                            findings: List[Finding]) -> None:
        name = dotted_name(call.func)
        if name is None or name.split(".")[-1] not in RESOLVE_FUNCS \
                or not call.args:
            return
        self._check_spec_literal(module, call.args[0],
                                 f"passed to {name}()", findings)

    def _check_spec_defaults(self, module: Module, fn,
                             findings: List[Finding]) -> None:
        a = fn.args
        for args_list, defaults in ((a.args + a.posonlyargs, a.defaults),
                                    (a.kwonlyargs, a.kw_defaults)):
            pairs = zip(args_list[-len(defaults):], defaults) \
                if defaults else ()
            for arg, default in pairs:
                if default is None:
                    continue
                if arg.arg in SPEC_PARAMS or arg.arg.endswith("_spec"):
                    self._check_spec_literal(
                        module, default,
                        f"as default of parameter {arg.arg!r}", findings)
