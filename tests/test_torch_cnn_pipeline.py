"""The CNN edge-cloud pipeline (the paper's own workload) of the port
through the full switching stack, the twin of tests/test_cnn_pipeline.py:
split correctness (bit-equal within the port), varying boundary bytes, a
live repartition, every strategy of tests/test_torch_stages.py with the
logits unchanged and within 1e-4 of the JAX pipeline's on the same
weights, and examples/serve_pipeline_torch.py's smoke on the CPU."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.core.network import NetworkModel as JNet  # noqa: E402
from repro.core.pipeline import EdgeCloudPipeline as JPipeline  # noqa: E402
from repro.core.stages import CnnStageRunner as JRunner  # noqa: E402
from repro.models import cnn as JC  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core.network import NetworkModel  # noqa: E402
from repro_torch.core.partitioner import optimal_split  # noqa: E402
from repro_torch.core.profiler import profile_cnn  # noqa: E402
from repro_torch.core.stages import CnnStageRunner  # noqa: E402
from repro_torch.core.switching import PipelineManager  # noqa: E402
from repro_torch.params import from_numpy  # noqa: E402
from test_torch_stages import STRATEGIES  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
HW = 64


@pytest.fixture(scope="module")
def setup():
    cfg = dataclasses.replace(get_config("mobilenetv2"), input_hw=HW)
    jp, _, _ = JC.build_cnn(cfg, jax.random.PRNGKey(0))
    runner = CnnStageRunner(dataclasses.replace(tget("mobilenetv2"),
                                                input_hw=HW),
                            from_numpy(jax.tree.map(np.asarray, jp)),
                            device="cpu")
    rng = np.random.default_rng(0)
    img = rng.standard_normal((1, HW, HW, 3), dtype=np.float32)
    return cfg, jp, runner, img


def test_cnn_split_equals_monolithic(setup):
    _, _, runner, img = setup
    img = {"image": torch.from_numpy(img)}
    n = runner.num_units
    full = runner.stage_executable(0, n, runner.params, img,
                                   fresh=True)(runner.params, img)
    for split in range(n - 1):
        mid = runner.stage_executable(0, split + 1, runner.params,
                                      img)(runner.params, img)
        assert set(mid) == {"h"} and tuple(mid["h"].shape) == \
            runner.stage_out_avals(0, split + 1, runner.params, img)["h"].shape
        out = runner.stage_executable(split + 1, n, runner.params,
                                      mid)(runner.params, mid)
        assert torch.equal(out["logits"], full["logits"]), split


def test_cnn_boundary_bytes_vary(setup):
    """The property that makes CNN repartitioning non-trivial (Fig. 2-3)."""
    _, _, runner, _ = setup
    sizes = {runner.boundary_bytes(i, 1) for i in range(runner.num_units - 1)}
    assert len(sizes) > 3


def test_cnn_pipeline_switches_live(setup):
    cfg, _, runner, img = setup
    img = {"image": torch.from_numpy(img)}
    profile = profile_cnn(cfg, runner.params, runner.units, runner.shapes,
                          reps=1)
    fast = optimal_split(profile, NetworkModel(20.0)).split
    slow = optimal_split(profile, NetworkModel(0.5)).split
    assert fast != slow          # the optimum must move for this test
    mgr = PipelineManager(runner, split=fast, net=NetworkModel(20.0),
                          sample_inputs=img)
    ref, _ = mgr.serve(img)
    mgr.set_network(NetworkModel(0.5))
    rep = mgr.repartition("switch_b2", slow)
    assert not rep.full_outage
    out, _ = mgr.serve(img)
    assert torch.equal(out, ref)
    mgr.close()


def test_every_strategy_keeps_logits_and_matches_jax(setup):
    """Every strategy of the stateless path's test: the logits stay
    bit-equal across the switches (pause_resume reloads the checkpoint
    into the conv layout) and within 1e-4 of the JAX pipeline's."""
    cfg, jp, runner, img = setup
    jpipe = JPipeline(JRunner(cfg, params=jp), 3, JNet(20.0))
    jpipe.build({"image": img}, cold=False)
    want, _ = jpipe.process({"image": img})
    inputs = {"image": torch.from_numpy(img)}
    mgr = PipelineManager(runner, split=3, net=NetworkModel(20.0),
                          sample_inputs=inputs, standby_split=2)
    ref, _ = mgr.serve(inputs)
    np.testing.assert_allclose(ref.numpy(), np.asarray(want), atol=1e-4)
    for strategy, split in STRATEGIES:
        rep = mgr.repartition(strategy, split)
        assert rep.new_split == split and mgr.active.split == split
        out, timing = mgr.serve(inputs)
        assert torch.equal(out, ref), strategy
        assert timing.t_edge > 0 and timing.t_cloud > 0
    m = mgr.memory_report()
    assert m["initial_bytes"] > 0
    mgr.close()


def test_serve_pipeline_example_smoke_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable,
                          str(REPO / "examples" / "serve_pipeline_torch.py"),
                          "--smoke", "--device", "cpu", "--hw", str(HW)],
                         env=env, capture_output=True, text=True, timeout=300,
                         cwd=str(REPO))
    assert out.returncode == 0, out.stderr[-2000:]
    assert "paper ordering reproduced on the measured stream" in out.stdout
    for strategy in ("switch_a", "switch_b2", "pause_resume"):
        assert f"{strategy:13s}: 2 switches" in out.stdout, out.stdout
