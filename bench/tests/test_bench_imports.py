"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program.  Top-level module names are
compared whole: the port's ``repro_torch`` is not ``repro``."""
import ast
import sys
import types

from bench.harness import main as H
from bench.harness import spec as S

REFUSED = {"jax", "jaxlib", "flax", "repro"}


def imported(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module.split(".")[0]


def test_no_jax_anywhere():
    for path in S.BENCH.rglob("*.py"):
        assert not set(imported(path)) & REFUSED, path


def test_reference_imports_nothing_of_the_program():
    for path in (S.BENCH / "reference").rglob("*.py"):
        names = set(imported(path))
        assert "repro_torch" not in names, path
        assert names <= {"__future__", "contextlib", "math", "torch",
                         "bench"}, (path, names)


def test_forbidden_modules_compare_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_extra",
                        types.ModuleType("repro_torch_extra"))
    assert H.forbidden_modules() == [
        m for m in ("flax", "jax", "jaxlib", "repro")
        if m in {n.split(".")[0] for n in sys.modules}]
    monkeypatch.setitem(sys.modules, "jax.numpy",
                        types.ModuleType("jax.numpy"))
    assert "jax" in H.forbidden_modules()
