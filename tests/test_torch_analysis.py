"""The port's lint (``repro_torch.analysis``) against the reference's
(``repro.analysis``): NK01, NK02 and NK04, inline suppression, the
baseline round trip and the CLI's exit codes on the same source snippets
through both tools, with equal findings (rule, line, severity); NK03's
counterpart, the host-sync rule over the per-step path (``@counted_kernel``
wrappers and the runners' ``_make_*_fn`` step callables, transitively to
depth 2); and ``src/repro_torch`` clean with no baseline, every NK03
suppression there carrying a reason."""
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro.analysis.core import Project as JProject  # noqa: E402
from repro.analysis.core import run_rules as jrun  # noqa: E402
from repro.analysis.nk01_locks import LockDisciplineRule as JNK01  # noqa: E402
from repro.analysis.nk02_clock import ClockDisciplineRule as JNK02  # noqa: E402
from repro.analysis.nk04_registry import RegistryHygieneRule as JNK04  # noqa: E402
from repro.analysis.nk04_registry import spec_error as jspec_error  # noqa: E402
from repro_torch.analysis import baseline as bl  # noqa: E402
from repro_torch.analysis.cli import DEFAULT_BASELINE, main  # noqa: E402
from repro_torch.analysis.core import (Project, all_rules,  # noqa: E402
                                       run_rules)
from repro_torch.analysis.nk01_locks import LockDisciplineRule  # noqa: E402
from repro_torch.analysis.nk02_clock import ClockDisciplineRule  # noqa: E402
from repro_torch.analysis.nk03_host_sync import HostSyncRule  # noqa: E402
from repro_torch.analysis.nk04_registry import (  # noqa: E402
    RegistryHygieneRule, spec_error)

REPO = Path(__file__).resolve().parent.parent
RULES = {"NK01": (JNK01, LockDisciplineRule),
         "NK02": (JNK02, ClockDisciplineRule),
         "NK04": (JNK04, RegistryHygieneRule)}

# -- the reference's snippets (tests/test_analysis.py), NK01/NK02/NK04 ----

NK01_BAD = '''
from repro.core.concurrency import guarded_by, make_lock

@guarded_by("_lock", "_entries", rank=10)
class Pool:
    def __init__(self):
        self._lock = make_lock("pool", 10)
        self._entries = {}

    def size(self):
        return len(self._entries)
'''
NK01_GOOD = NK01_BAD.replace(
    "        return len(self._entries)",
    "        with self._lock:\n            return len(self._entries)")
NK01_COMMENT = '''
from repro.core.concurrency import make_lock

class Q:
    def __init__(self):
        self._lock = make_lock("q", 10)
        self._jobs = []      # guarded-by: _lock

    def bad(self):
        return self._jobs
'''
NK01_HOLDS = NK01_BAD.replace("    def size(self):",
                              "    def _peek(self):   # holds: _lock")
NK01_INVERSION = '''
from repro.core.concurrency import guarded_by, make_lock

@guarded_by("_outer", "_a", rank=20)
@guarded_by("_inner", "_b", rank=10)
class C:
    def __init__(self):
        self._outer = make_lock("o", 20)
        self._inner = make_lock("i", 10)
        self._a = 0
        self._b = 0

    def bad(self):
        with self._outer:
            with self._inner:
                self._b = 1
'''
NK01_NESTED = NK01_GOOD.replace(
    "            return len(self._entries)",
    "            return lambda: len(self._entries)")
NK02_BAD = '''
import time
from time import monotonic as mono

def f():
    return time.perf_counter() + mono()
'''
NK02_GOOD = '''
from repro.core.timing import Stopwatch

def f():
    sw = Stopwatch()
    return sw.elapsed()
'''
NK02_STANDALONE = '''
import time

def f():
    # nk: allow[NK02]: deliberate wall site
    t = time.perf_counter()
    return t + time.monotonic()
'''
NK04_BAD = '''
from repro.core.strategies import register_strategy

@register_strategy("dup")
class A:
    pass

@register_strategy("dup")
class B:
    pass
'''
NK04_GOOD = '''
from repro.core.strategies import get_strategy, register_strategy

@register_strategy("one")
class A:
    pass

@register_strategy("two")
class B:
    pass

def run():
    return get_strategy("one(k=2, mode='fast')")
'''
NK04_SHADOWED = '''
from repro.core.strategies import register_policy

@register_policy("real")
class P:
    name = "other"
'''
NK04_SPECS = '''
from repro.core.strategies import get_strategy

def run(strategy="pool(k=)"):
    return get_strategy("switch pool(k=2)")
'''

# (rule, {path: source}, findings expected)
CASES = {
    "nk01_unlocked": ("NK01", {"src/p.py": NK01_BAD}, 1),
    "nk01_under_lock": ("NK01", {"src/p.py": NK01_GOOD}, 0),
    "nk01_comment": ("NK01", {"src/q.py": NK01_COMMENT}, 1),
    "nk01_holds": ("NK01", {"src/p.py": NK01_HOLDS}, 0),
    "nk01_inversion": ("NK01", {"src/c.py": NK01_INVERSION}, 1),
    "nk01_nested": ("NK01", {"src/p.py": NK01_NESTED}, 1),
    "nk01_foreign": ("NK01", {"src/p.py": NK01_GOOD, "src/user.py":
                              "def steal(pool):\n    return pool._entries\n"},
                     1),
    "nk02_wall_clocks": ("NK02", {"src/f.py": NK02_BAD}, 2),
    "nk02_timing": ("NK02", {"src/f.py": NK02_GOOD}, 0),
    "nk04_duplicate": ("NK04", {"src/r.py": NK04_BAD}, 1),
    "nk04_clean": ("NK04", {"src/r.py": NK04_GOOD}, 0),
    "nk04_shadowed": ("NK04", {"src/r.py": NK04_SHADOWED}, 1),
    "nk04_redundant": ("NK04", {"src/r.py": NK04_SHADOWED.replace(
        'name = "other"', 'name = "real"')}, 1),
    "nk04_specs": ("NK04", {"src/r.py": NK04_SPECS}, 2),
    "allow_trailing": ("NK02", {"src/f.py": NK02_BAD.replace(
        "mono()\n", "mono()   # nk: allow[NK02]\n")}, 0),
    "allow_other_rule": ("NK02", {"src/f.py": NK02_BAD.replace(
        "mono()\n", "mono()   # nk: allow[NK01]\n")}, 2),
    "allow_standalone": ("NK02", {"src/f.py": NK02_STANDALONE}, 1),
}


def both(rule, sources):
    """(reference findings, port findings) as (path, rule, line,
    severity)."""
    jrule, trule = RULES[rule]
    key = lambda f: (f.path, f.rule, f.line, f.severity)  # noqa: E731
    return ([key(f) for f in jrun(JProject.from_sources(sources), [jrule()])],
            [key(f) for f in run_rules(Project.from_sources(sources),
                                       [trule()])])


@pytest.mark.parametrize("case", sorted(CASES))
def test_findings_equal_the_references(case):
    rule, sources, n = CASES[case]
    want, got = both(rule, sources)
    assert got == want and len(got) == n


def test_nk02_sanctions_the_ports_timing_modules():
    for path in ("src/repro_torch/core/timing.py",
                 "src/repro_torch/serving/clock.py"):
        assert run_rules(Project.from_sources({path: NK02_BAD}),
                         [ClockDisciplineRule()]) == []
    # and only the port's: the reference's modules are not sanctioned here
    assert len(run_rules(Project.from_sources(
        {"src/repro/core/timing.py": NK02_BAD}),
        [ClockDisciplineRule()])) == 2


@pytest.mark.parametrize("spec", ["pool", "pool(k=2, mode='fast')",
                                  "switch pool", "pool(k=)", "pool(2)",
                                  "pool(k=f())"])
def test_spec_grammar_equals_the_references(spec):
    assert (spec_error(spec) is None) == (jspec_error(spec) is None)


def test_baseline_round_trip_and_line_drift(tmp_path):
    fs = run_rules(Project.from_sources({"src/f.py": NK02_BAD}),
                   [ClockDisciplineRule()])
    path = tmp_path / "baseline.json"
    bl.save(path, fs)
    new, matched, stale = bl.diff(fs, bl.load(path))
    assert not new and not stale and len(matched) == len(fs)
    drifted = run_rules(Project.from_sources(
        {"src/f.py": "# header\n# comment\n" + NK02_BAD}),
        [ClockDisciplineRule()])
    new, matched, stale = bl.diff(drifted, bl.load(path))
    assert not new and not stale
    new, matched, stale = bl.diff([], bl.load(path))
    assert not new and len(stale) == len({f.key() for f in fs})
    assert bl.load(tmp_path / "missing.json") == {}


def test_cli_exit_codes(tmp_path, monkeypatch):
    """0 clean, 1 new findings, 2 unparseable; the default baseline is
    ``analysis-baseline-torch.json`` (missing reads as empty) and the
    reference's ``analysis-baseline.json`` is never read or written."""
    monkeypatch.chdir(tmp_path)
    ref_baseline = tmp_path / "analysis-baseline.json"
    ref_baseline.write_text('{"findings": [{"path": "x", "rule": "NK02", '
                            '"context": "y"}]}\n')
    before = ref_baseline.read_text()
    bad = tmp_path / "bad.py"
    bad.write_text(NK02_BAD)
    good = tmp_path / "good.py"
    good.write_text("def f():\n    return 1\n")
    broken = tmp_path / "broken.py"
    broken.write_text("def f(:\n")
    assert DEFAULT_BASELINE == "analysis-baseline-torch.json"
    assert main([str(bad), "--no-baseline"]) == 1
    assert main([str(good), "--no-baseline"]) == 0
    assert main([str(broken)]) == 2
    assert main([str(bad)]) == 1
    assert main([str(bad), "--write-baseline"]) == 0
    assert (tmp_path / DEFAULT_BASELINE).exists()
    assert main([str(bad)]) == 0
    assert ref_baseline.read_text() == before


# -- NK03: host syncs on the per-step path ---------------------------------

NK03_KERNEL = '''
import time
from repro_torch.distributed.op_analysis import counted_kernel

def work(x):
    return 0, 0

@counted_kernel(work)
def my_kernel(x, *, pos):
    t0 = time.perf_counter()
    n = x.item()
    host = x.cpu()
    s = float(x)
    rows = int(x.shape[0]) + int(len(pos)) + int(x.numel() > 1)
    return x * n + s + t0 + rows
'''

NK03_RUNNER = '''
class Runner:
    def _finish(self, x):
        return x.tolist()

    def _unit(self, x):
        return self._finish(x)

    def _make_decode_fn(self, u0, u1):
        def fn(params, x, cache, pos):
            step = int(pos)
            return self._unit(x) + step
        return fn
'''

NK03_DEEP = '''
from repro_torch.distributed.op_analysis import counted_kernel

def third(x):
    return x.numpy()

def second(x):
    return third(x)

def first(x):
    return second(x) + x.tolist()

@counted_kernel(None)
def root(x):
    return first(x)
'''

NK03_PURE = '''
import torch
from repro_torch.distributed.op_analysis import counted_kernel

@counted_kernel(None)
def my_kernel(q, k, *, causal=True):
    B, S = q.shape[0], int(k.shape[2])
    out = torch.empty_like(q)
    return out[: max(B, S)]

class Runner:
    def _make_head_fn(self):
        def fn(params, x):
            return x @ params["w"]
        return fn

def not_a_root(x):
    return float(x.item())
'''


def nk03(sources):
    return run_rules(Project.from_sources(sources), [HostSyncRule()])


def test_nk03_flags_a_counted_kernel():
    fs = nk03({"src/repro_torch/kernels/k.py": NK03_KERNEL})
    msgs = {f.line: f.message for f in fs}
    assert sorted(msgs) == [10, 11, 12, 13]     # the shape ints pass
    assert "perf_counter" in msgs[10] and "impure" in msgs[10]
    assert ".item()" in msgs[11] and ".cpu()" in msgs[12]
    assert "float()" in msgs[13] and all(f.rule == "NK03" for f in fs)


def test_nk03_flags_a_step_callable_and_its_methods():
    fs = nk03({"src/repro_torch/core/r.py": NK03_RUNNER})
    assert [(f.line, f.message.split()[0]) for f in fs] == \
        [(4, ".tolist()"), (11, "int()")]


def test_nk03_walks_to_depth_two():
    fs = nk03({"src/repro_torch/kernels/k.py": NK03_DEEP})
    # first (depth 1) and second (depth 2) are read; third is not
    assert [f.line for f in fs] == [11]
    deeper = NK03_DEEP.replace("return second(x) + x.tolist()",
                               "return second(x)").replace(
        "def second(x):\n    return third(x)",
        "def second(x):\n    return x.cpu()")
    assert [f.line for f in nk03({"src/k.py": deeper})] == [8]


def test_nk03_pure_roots_clean():
    assert nk03({"src/repro_torch/kernels/k.py": NK03_PURE}) == []


def test_nk03_cross_module_and_suppression():
    helper = "def sync(x):\n    return x.item()\n"
    root = ('from repro_torch.distributed.op_analysis import counted_kernel\n'
            'from repro_torch.h import sync\n'
            'from repro_torch import h as H\n\n'
            '@counted_kernel(None)\n'
            'def k(x):\n'
            '    return sync(x) + H.sync(x)\n')
    fs = nk03({"src/repro_torch/h.py": helper, "src/repro_torch/k.py": root})
    assert [(f.path, f.line) for f in fs] == [("src/repro_torch/h.py", 2)]
    allowed = helper.replace("x.item()",
                             "x.item()  # nk: allow[NK03]: a host read")
    assert nk03({"src/repro_torch/h.py": allowed,
                 "src/repro_torch/k.py": root}) == []


# -- the port's own tree ---------------------------------------------------

def test_port_tree_is_clean_without_a_baseline(monkeypatch):
    monkeypatch.chdir(REPO)
    project = Project.from_paths(["src/repro_torch"])
    fs = run_rules(project, all_rules())
    assert fs == [], "\n".join(f.render() for f in fs)
    assert main(["src/repro_torch", "--no-baseline"]) == 0


def test_every_nk03_suppression_carries_a_reason():
    allow = re.compile(r"#\s*nk:\s*allow\[([A-Za-z0-9_,\s]+)\](.*)")
    sites = []
    for path in sorted((REPO / "src/repro_torch").rglob("*.py")):
        for n, line in enumerate(path.read_text().splitlines(), 1):
            m = allow.search(line)
            if m and "NK03" in m.group(1).upper():
                sites.append((path.name, n))
                assert re.match(r"\s*:\s*\S", m.group(2)), (path, n)
    assert len(sites) >= 5
