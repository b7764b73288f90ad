"""A pipeline built while the link changes lands on the new link.

``PipelinePool.set_network`` reaches the pipelines that have landed; one
being built on the worker at that moment took the pool's link when it was
made.  A switch_a standby re-armed at one change point and still building
at the next then served the rest of the stream priced at the old link
(phase 8c of chip_smoke.py on the card: vgg19's latencies doubled after
the second switch).  The pool gives a pipeline its current link as the
pipeline lands."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.network import NetworkModel  # noqa: E402
from repro_torch.core.pipeline import EdgeCloudPipeline  # noqa: E402
from repro_torch.core.stages import CnnStageRunner  # noqa: E402
from repro_torch.core.switching import PipelineManager  # noqa: E402

HW = 32


@pytest.fixture
def mgr():
    cfg = dataclasses.replace(get_config("mobilenetv2"), input_hw=HW)
    runner = CnnStageRunner(cfg, generator=torch.Generator().manual_seed(0),
                            device="cpu")
    img = {"image": torch.zeros((1, HW, HW, cfg.input_ch))}
    m = PipelineManager(runner, split=2, net=NetworkModel(20.0),
                        sample_inputs=img, warm_standbys=True)
    yield m
    m.close()


def _link_changes_while_building(monkeypatch, mgr, mbps: float):
    """Every build from now on sees the link change to ``mbps`` once
    its stages are built and before it lands."""
    real = EdgeCloudPipeline.build

    def build(pipe, *args, **kwargs):
        rep = real(pipe, *args, **kwargs)
        mgr.set_network(NetworkModel(mbps))
        return rep
    monkeypatch.setattr(EdgeCloudPipeline, "build", build)


def test_ensure_lands_on_the_link_set_during_the_build(monkeypatch, mgr):
    _link_changes_while_building(monkeypatch, mgr, 5.0)
    entry, hit = mgr.pool.ensure(4, cold=True, reuse=False)
    assert not hit
    assert entry.pipeline.net.bandwidth_mbps == 5.0
    assert mgr.pool.net.bandwidth_mbps == 5.0


def test_switch_a_rearmed_standby_takes_the_new_link(monkeypatch, mgr):
    """The standby switch_a re-arms on the worker after its swap, built
    across a change of the link, serves at the changed link."""
    mgr.get_strategy("switch_a").prepare(mgr.pool, candidate_splits=[3])
    _link_changes_while_building(monkeypatch, mgr, 5.0)
    rep = mgr.repartition("switch_a", 3)
    assert rep.new_split == 3
    mgr.drain()
    standby = mgr.pool.standby
    assert standby is not None and standby.split == 2
    assert standby.net.bandwidth_mbps == 5.0
    for key in mgr.pool.keys():
        assert mgr.pool.get(key).pipeline.net.bandwidth_mbps == 5.0, key
