"""What depends on the architecture is found by name and unchanged by its
move there, and the harness and drivers name no family, configuration or
kernel.

``fixtures/parent_readings.json`` was recorded on the CPU from the code
as it stood before the families' files existed (weights in
``bench/harness/weights.py``, the reference in one module, the work in
``bench/work/model.py`` and ``bench/work/kernels.py``), by the readings
``_readings`` makes here: each configuration's full-width normal leaves
(paths, shapes, stds, order), and at the tiny size a checksum of every
leaf of its weight tree, the reference's logits in f32 and under the
control's weights, and ``event_work`` over a fixed list of events at both
sizes.  Each has to match bit for bit."""
import hashlib
import json
import re

import pytest
import torch

from bench.harness import spec as S
from bench.harness.weights import make_weights
from bench.reference import control as C
from bench.tests import tiny
from bench.work import model as M

PARENT = S.load_json(S.BENCH / "tests" / "fixtures" / "parent_readings.json")


def _digest(t):
    return hashlib.sha256(t.detach().contiguous().cpu().view(torch.uint8)
                          .numpy().tobytes()).hexdigest()


def _tree_leaves(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _tree_leaves(v, prefix + k + "/")
        else:
            yield prefix + k, v


@pytest.fixture
def two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)            # as the fixtures were recorded
    yield
    torch.set_num_threads(old)


def _full(config):
    return S.load_json(S.BENCH / "configs" / f"{config}.json")["port"]


@pytest.mark.parametrize("config", sorted(PARENT["configs"]))
def test_full_width_leaves_match_the_parent(config):
    port = _full(config)
    leaves = S.family(port["family"], "weights").leaves(port)
    assert [[p, list(s), std] for p, s, std in leaves] \
        == PARENT["configs"][config]["leaves"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("config", sorted(PARENT["configs"]))
def test_tiny_weights_match_the_parent(config, dtype):
    w = make_weights(tiny.port(config), 11, "cpu", getattr(torch, dtype))
    assert [[p, str(t.dtype), list(t.shape), _digest(t)]
            for p, t in _tree_leaves(w)] \
        == PARENT["configs"][config][f"weights_{dtype}"]


@pytest.mark.parametrize("config", sorted(PARENT["configs"]))
def test_reference_matches_the_parent(config, two_threads):
    port = tiny.port(config)
    R = S.family(port["family"], "reference")
    w = make_weights(port, 12, "cpu", torch.float32)
    toks = torch.randint(0, port["vocab_size"], (40,),
                         generator=torch.Generator().manual_seed(3))
    ref = R.forward_logits(port, w, toks)
    low = R.forward_logits(port, w, toks, weight=C.low_precision)
    want = PARENT["configs"][config]
    assert ref[::7, ::11].flatten().tolist() == want["logits_sample"]
    assert _digest(ref) == want["logits"]
    assert _digest(low) == want["logits_low"]


@pytest.mark.parametrize("size", ["full", "tiny"])
@pytest.mark.parametrize("config", sorted(PARENT["configs"]))
def test_work_matches_the_parent(config, size):
    port = _full(config) if size == "full" else tiny.port(config)
    g = M.dims(port)
    got = [json.loads(json.dumps(M.event_work(g, e)))
           for e in PARENT["events"]]
    assert got == PARENT["configs"][config]["work"][size]


def _names():
    """Every family, configuration and kernel the benchmark has."""
    bench = S.load_json(S.ROOT / "BENCHMARK.json")
    families = {S.load_json(S.ROOT / c["file"])["port"]["family"]
                for c in bench["configs"]}
    families |= {p.name for p in (S.BENCH / "families").iterdir()
                 if p.is_dir() and not p.name.startswith("_")}
    configs = {c["name"] for c in bench["configs"]}
    return families | configs | set(S.kernels())


def test_harness_and_drivers_name_no_family_config_or_kernel():
    names = _names()
    assert {"ssm", "hybrid", "falcon-mamba-7b", "zamba2-7b", "ssd_scan",
            "mamba1_scan", "flash_attention", "flash_decode"} <= names
    word = re.compile(r"(?<![\w-])(%s)(?![\w-])"
                      % "|".join(map(re.escape, sorted(names))), re.I)
    for d in ("harness", "drivers"):
        for path in (S.BENCH / d).rglob("*.py"):
            found = word.findall(path.read_text())
            assert not found, (path, found)


def test_kernel_files_hold_their_three_parts():
    for name, k in S.kernels().items():
        assert isinstance(k.DEVICE_NAME, str) and k.DEVICE_NAME, name
        assert callable(k.launches) and callable(k.work), name
