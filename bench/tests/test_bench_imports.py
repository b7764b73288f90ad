"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program.  Top-level module names are
compared whole: the port's ``repro_torch`` is not ``repro``."""
import ast
import subprocess
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


REFERENCES = [*(S.BENCH / "reference").rglob("*.py"),
              *S.BENCH.rglob("families/*/reference.py"),
              S.BENCH / "tests" / "third_family" / "reference.py"]


def test_reference_imports_nothing_of_the_program():
    for path in REFERENCES:
        names = set(imported(path))
        assert "repro_torch" not in names, path
        assert names <= {"__future__", "contextlib", "math", "torch",
                         "bench"}, (path, names)


def test_a_family_reference_loads_nothing_of_the_program():
    """What a family's reference imports (the shared pieces, the family's
    work and the kernels' formulas) loads no module of the program."""
    code = ("import sys; from bench.harness import spec as S\n"
            "for f in sys.argv[1:]: S.family(f, 'reference')\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}"
            " & {'repro_torch', 'repro', 'jax'}))")
    families = sorted(p.parent.name
                      for p in S.BENCH.glob("families/*/reference.py"))
    out = subprocess.run([sys.executable, "-c", code, *families],
                         cwd=S.ROOT, capture_output=True, text=True,
                         check=True)
    assert families and out.stdout.strip() == "[]", out


def test_forbidden_modules_compare_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_extra",
                        types.ModuleType("repro_torch_extra"))
    assert H.forbidden_modules() == [
        m for m in ("flax", "jax", "jaxlib", "repro")
        if m in {n.split(".")[0] for n in sys.modules}]
    monkeypatch.setitem(sys.modules, "jax.numpy",
                        types.ModuleType("jax.numpy"))
    assert "jax" in H.forbidden_modules()
