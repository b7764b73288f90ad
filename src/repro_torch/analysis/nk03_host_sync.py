"""NK03 — host-sync hygiene on the per-step path.

The reference's NK03 looks inside ``jax.jit`` and ``pl.pallas_call``
bodies, where a wall clock or a random draw is frozen into the graph and
a ``float(x)`` forces a host sync.  The port has neither: it runs eagerly,
and what every decode step runs is its kernel wrappers and the step
callables its runners build.  There a host sync stalls the launch queue
each step, and it is what keeps a step from being captured in a CUDA
graph; an impure call runs on every step instead of once.  So the roots
are

* functions decorated ``@counted_kernel`` (the hand-written kernels'
  wrappers, ``kernels/*.py``);
* functions defined inside a method named ``_make_*_fn`` or
  ``stage_executable``: the step callables the runners return
  (``core/stateful.py``, ``core/stages.py``);

and the rule walks each root and, transitively (depth 2, as the
reference's), every project-local function it calls — a module-level
function of its own module, one reached through an import alias, or a
``self.<method>`` of its class (or, where the class has none, of another
class in its module) — flagging

* **impure calls**: ``time.*``, ``random.*``, ``np.random.*``, ``print``,
  ``open``, ``input`` (the reference's list);
* **host syncs**: ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
  ``float``/``int``/``bool`` of a value that is not a host value (a
  literal, a ``.shape``, ``len()``, ``.size()``, ``.numel()``, ``.dim()``,
  ``.element_size()``, ``.stride()``, or arithmetic and comparisons of
  them), and any call named ``synchronize*`` (``torch.cuda.synchronize``,
  the port's ``device.synchronize`` and ``tp.synchronize_mesh``);
* **host-built tensors sent to the device**: ``torch.from_numpy(...)``,
  ``torch.tensor(...)`` or ``torch.as_tensor(...)`` given ``device=``, or
  followed by ``.to(<device>)`` (chained, or through a name the function
  assigned it to).  The copy from pageable host memory waits on the card
  mid-step, and a CUDA graph cannot capture it: build such a table once
  on the device.

A sync that is the point (a counter read off the device, an integer
position that arrives from the host) is annotated
``# nk: allow[NK03]: <why>`` at the site.
"""
from __future__ import annotations

import ast
import re
from typing import Dict, Iterator, List, Optional, Set, Tuple

from repro_torch.analysis.core import (Finding, Module, Project, Rule,
                                       decorator_call, dotted_name,
                                       import_aliases)

IMPURE_PREFIXES = ("time.", "random.", "np.random.", "numpy.random.",
                   "os.urandom")
IMPURE_BARE = frozenset({"print", "open", "input"})
SYNC_METHODS = frozenset({"item", "tolist", "cpu", "numpy"})
COERCIONS = frozenset({"float", "int", "bool"})
# calls whose result is a host value, whatever their receiver
HOST_METHODS = frozenset({"size", "numel", "dim", "element_size", "stride"})
# constructors of a tensor from host data
HOST_BUILDERS = frozenset({"torch.from_numpy", "torch.tensor",
                           "torch.as_tensor"})
DTYPES = frozenset({"float", "double", "half", "bfloat16", "float16",
                    "float32", "float64", "int", "long", "short", "bool",
                    "int8", "int16", "int32", "int64", "uint8", "cfloat",
                    "complex64", "complex128"})
ROOT_DECORATORS = frozenset({"counted_kernel"})
STEP_FACTORY = re.compile(r"^(_make_\w*_fn|stage_executable)$")
MAX_DEPTH = 2

FuncDef = (ast.FunctionDef, ast.AsyncFunctionDef)


def _host_built(node: ast.expr, aliases: Dict[str, str],
                host_names: Set[str]) -> bool:
    """A tensor built from host data (``HOST_BUILDERS``), or a name the
    function bound to one."""
    if isinstance(node, ast.Name):
        return node.id in host_names
    if not isinstance(node, ast.Call):
        return False
    name = dotted_name(node.func)
    if name is None or "." not in name:
        return False
    head, tail = name.split(".", 1)
    return f"{aliases.get(head, head)}.{tail}" in HOST_BUILDERS


def _dtype_arg(node: ast.expr) -> bool:
    """A ``.to()`` argument that names a dtype, not a device."""
    name = dotted_name(node)
    if name is None:
        return False
    last = name.split(".")[-1]
    return last in DTYPES or last.endswith("dtype")


def _to_device(node: ast.Call) -> bool:
    """A ``.to(...)`` call that names a device (or a tensor's)."""
    if any(k.arg == "device" for k in node.keywords):
        return True
    return any(not _dtype_arg(a) for a in node.args)


def _host_value(node: ast.expr) -> bool:
    """A value known on the host without a sync: a literal, a shape or
    size query, or arithmetic and comparisons of such values."""
    if isinstance(node, ast.Constant):
        return True
    if isinstance(node, ast.Attribute):
        return node.attr == "shape"
    if isinstance(node, ast.Subscript):
        return _host_value(node.value)
    if isinstance(node, ast.BinOp):
        return _host_value(node.left) and _host_value(node.right)
    if isinstance(node, ast.UnaryOp):
        return _host_value(node.operand)
    if isinstance(node, ast.Compare):
        return all(map(_host_value, [node.left, *node.comparators]))
    if isinstance(node, ast.BoolOp):
        return all(map(_host_value, node.values))
    if isinstance(node, ast.Call):
        if isinstance(node.func, ast.Name):
            return node.func.id == "len"
        if isinstance(node.func, ast.Attribute):
            return node.func.attr in HOST_METHODS
    return False


class _Index:
    """Project functions by name: module-level ones as
    '<module>.<func>', methods as '<module>.<Class>.<method>'."""

    def __init__(self, project: Project):
        self.funcs: Dict[str, Tuple[Module, ast.AST]] = {}
        self.methods: Dict[str, Dict[str, List[ast.AST]]] = {}
        # a function's enclosing class, by (path, line)
        self.owner: Dict[Tuple[str, int], str] = {}
        for module in project.modules:
            by_name = self.methods.setdefault(module.name, {})
            for node in module.tree.body:
                if isinstance(node, FuncDef):
                    self.funcs[f"{module.name}.{node.name}"] = (module, node)
                elif isinstance(node, ast.ClassDef):
                    for item in node.body:
                        if isinstance(item, FuncDef):
                            self.funcs[f"{module.name}.{node.name}."
                                       f"{item.name}"] = (module, item)
                            by_name.setdefault(item.name, []).append(item)
                    for sub in ast.walk(node):
                        if isinstance(sub, FuncDef):
                            self.owner[(module.path, sub.lineno)] = node.name

    def callees(self, module: Module, fn: ast.AST, name: str,
                aliases: Dict[str, str]) -> List[Tuple[Module, ast.AST]]:
        """The project functions a call named ``name`` inside ``fn`` may
        reach."""
        if "." not in name:
            hit = self.funcs.get(f"{module.name}.{name}") or \
                self.funcs.get(aliases.get(name, ""))
            return [hit] if hit else []
        head, _, tail = name.partition(".")
        if "." in tail:
            return []
        if head == "self":
            cls = self.owner.get((module.path, fn.lineno))
            hit = self.funcs.get(f"{module.name}.{cls}.{tail}")
            if hit is not None:
                return [hit]
            return [(module, m) for m in
                    self.methods.get(module.name, {}).get(tail, [])]
        target = aliases.get(head)
        hit = self.funcs.get(f"{target}.{tail}") if target else None
        return [hit] if hit else []


def _roots(module: Module) -> List[ast.AST]:
    out = []
    for node in ast.walk(module.tree):
        if not isinstance(node, FuncDef):
            continue
        for dec in node.decorator_list:
            name, _, _ = decorator_call(dec)
            if name is not None and name.split(".")[-1] in ROOT_DECORATORS:
                out.append(node)
                break
        if STEP_FACTORY.match(node.name):
            out.extend(sub for sub in ast.walk(node)
                       if isinstance(sub, FuncDef) and sub is not node)
    return out


class HostSyncRule(Rule):
    id = "NK03"
    title = "impure call or host sync on the per-step path"
    severity = "error"

    def run(self, project: Project) -> Iterator[Finding]:
        findings: List[Finding] = []
        index = _Index(project)
        seen: Set[Tuple[str, int]] = set()
        for module in project.modules:
            for fn in _roots(module):
                self._check_body(index, module, fn, 0, seen, findings)
        return iter(findings)

    def _check_body(self, index: _Index, module: Module, fn: ast.AST,
                    depth: int, seen: Set[Tuple[str, int]],
                    findings: List[Finding]) -> None:
        key = (module.path, fn.lineno)
        if key in seen:
            return
        seen.add(key)
        aliases = import_aliases(module.tree)
        host_names = {t.id for node in ast.walk(fn)
                      if isinstance(node, ast.Assign)
                      and _host_built(node.value, aliases, set())
                      for t in node.targets if isinstance(t, ast.Name)}
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            msg = self._violation(node, aliases, host_names)
            if msg is not None:
                findings.append(module.finding(self, node, msg))
                continue
            name = dotted_name(node.func)
            if depth >= MAX_DEPTH or name is None:
                continue
            for target in index.callees(module, fn, name, aliases):
                self._check_body(index, target[0], target[1], depth + 1,
                                 seen, findings)

    @staticmethod
    def _violation(node: ast.Call, aliases: Dict[str, str],
                   host_names: Set[str] = frozenset()) -> Optional[str]:
        if _host_built(node, aliases, set()) and \
                any(k.arg == "device" for k in node.keywords):
            return (f"{dotted_name(node.func)}(..., device=) on the "
                    f"per-step path copies host data to the device: a "
                    f"pageable copy waits on the card every step and no "
                    f"CUDA graph can capture it; build it once there")
        if isinstance(node.func, ast.Attribute) and node.func.attr == "to" \
                and _host_built(node.func.value, aliases, host_names) \
                and _to_device(node):
            return ("a host-built tensor .to(<device>) on the per-step "
                    "path: a pageable copy waits on the card every step "
                    "and no CUDA graph can capture it; build it once on "
                    "the device")
        name = dotted_name(node.func)
        if name is not None:
            head = name.split(".")[0]
            resolved = aliases.get(head, head)
            full = name if "." not in name else \
                f"{resolved}.{name.split('.', 1)[1]}"
            if name in IMPURE_BARE:
                return (f"{name}() on the per-step path runs on every "
                        f"step (a side effect in a step or a kernel "
                        f"wrapper)")
            if any(full.startswith(p) or name.startswith(p)
                   for p in IMPURE_PREFIXES):
                return (f"{name}() on the per-step path: an impure call "
                        f"in a step callable or a kernel wrapper")
            if name.split(".")[-1].startswith("synchronize"):
                return (f"{name}() on the per-step path waits for the "
                        f"device: a host sync in every step")
            if name in COERCIONS and node.args and \
                    not _host_value(node.args[0]):
                return (f"{name}() of a device value forces a host sync "
                        f"on the per-step path; keep it a tensor or pass "
                        f"the host value in")
        if isinstance(node.func, ast.Attribute) and \
                node.func.attr in SYNC_METHODS and not node.args:
            return (f".{node.func.attr}() on the per-step path copies to "
                    f"the host and waits for the device")
        return None
