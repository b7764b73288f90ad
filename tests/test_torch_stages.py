"""The port's stateless edge-cloud path against the JAX package on the
same weights: ``StageRunner`` at every split on the flash-attention route,
``EdgeCloudPipeline`` serving through a ``PipelineManager`` under every
strategy with unchanged logits, the paper's downtime ordering and Table I
memory, the stateful path's prefill and recompute arm on the kernel route,
and ``examples/quickstart_torch.py`` on the CPU."""
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
from repro.core.stages import StageRunner as JRunner  # noqa: E402
from repro.core.stateful import make_stateful_manager as jax_manager  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core.network import NetworkModel  # noqa: E402
from repro_torch.core.pipeline import EdgeCloudPipeline  # noqa: E402
from repro_torch.core.stages import StageRunner  # noqa: E402
from repro_torch.core.stateful import make_stateful_manager  # noqa: E402
from repro_torch.core.switching import PipelineManager  # noqa: E402
from repro_torch.launch.mesh import (reset_mesh_devices,  # noqa: E402
                                     set_mesh_devices)
from repro_torch.models.transformer import init_model  # noqa: E402
from repro_torch.params import from_numpy  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
SEQ = 24
STRATEGIES = [("switch_a", 2), ("switch_b1", 0), ("switch_b2", 2),
              ("pause_resume", 1), ("switch_pool(k=1)", 0)]


@pytest.fixture(scope="module")
def pair():
    """Reduced qwen2.5-3b (2 layers): one set of weights and one prompt in
    both packages; the JAX runner on its Pallas route, the port's on the
    flash-attention kernel's (its plain version on the CPU)."""
    cfg = get_config("qwen2.5-3b").reduced()
    params = JT.init_model(cfg, jax.random.PRNGKey(0))
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (1, SEQ))
    jr = JRunner(cfg, params, attn_impl="pallas")
    tr = StageRunner(tget("qwen2.5-3b").reduced(),
                     from_numpy(jax.tree.map(np.asarray, params)),
                     attn_impl="kernel", device="cpu")
    return jr, tr, tokens


def test_stage_runner_matches_jax_every_split(pair):
    jr, tr, tokens = pair
    assert tr.num_units == jr.num_units == tr.cfg.num_layers + 2
    want = np.asarray(jr.run_units({"tokens": tokens}, 0, jr.num_units)
                      ["logits"])
    inputs = {"tokens": torch.from_numpy(tokens)}
    mono = tr.run_units(inputs, 0, tr.num_units)["logits"]
    np.testing.assert_allclose(mono.numpy(), want, atol=1e-4)
    for split in range(tr.num_units - 1):
        mid = tr.run_units(inputs, 0, split + 1)
        out = tr.run_units(mid, split + 1, tr.num_units)["logits"]
        assert torch.equal(out, mono), f"split {split}"
        assert tr.boundary_bytes(split, 1, SEQ) == \
            jr.boundary_bytes(split, 1, SEQ)
        assert tr.edge_param_bytes(split) == jr.edge_param_bytes(split)


def test_stage_builds_cache_warm_and_not_fresh(pair):
    _, tr, tokens = pair
    inputs = {"tokens": torch.from_numpy(tokens)}
    fn = tr.stage_executable(0, 2, tr.params, inputs)
    assert tr.stage_executable(0, 2, tr.params, inputs) is fn
    fresh = tr.stage_executable(0, 2, tr.params, inputs, fresh=True)
    assert fresh is not fn
    assert tr.stage_executable(0, 2, tr.params, inputs) is fn
    mid = tr.stage_out_avals(0, 2, tr.params, inputs)
    got = fn(tr.params, inputs)
    assert tuple(got["h"].shape) == mid["h"].shape
    assert got["h"].dtype == mid["h"].dtype
    last = tr.stage_out_avals(2, tr.num_units, tr.params, mid)
    assert last["logits"].shape == (1, SEQ, tr.cfg.vocab_size)


def test_pipeline_matches_jax_pipeline(pair):
    jr, tr, tokens = pair
    jp = JPipeline(jr, 1, JNet(20.0))
    jp.build({"tokens": tokens}, cold=False)
    tp = EdgeCloudPipeline(tr, 1, NetworkModel(20.0))
    tp.build({"tokens": torch.from_numpy(tokens)}, cold=False)
    want, jt = jp.process({"tokens": tokens})
    got, tt = tp.process({"tokens": tokens})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    assert tt.t_transfer == jt.t_transfer
    assert tp.live_param_bytes() == jp.live_param_bytes()
    tp.close()
    assert not tp.ready and tp.live_param_bytes() == 0
    # the reference's sharded cloud stage: a 2-way mesh (two shards on the
    # CPU) serves the same logits and holds a second, sharded weight copy
    set_mesh_devices(["cpu"] * 2)
    try:
        mp = EdgeCloudPipeline(tr, 1, NetworkModel(20.0), mesh_shape=(2,))
        assert mp.build({"tokens": torch.from_numpy(tokens)},
                        cold=False).t_reshard > 0.0
        got, _ = mp.process({"tokens": tokens})
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
        assert mp.live_param_bytes() == 2 * jp.live_param_bytes()
        mp.close()
    finally:
        reset_mesh_devices()


def test_switching_preserves_logits_every_strategy(pair):
    """Every registered strategy of the reference's switching test, plus
    switch_pool: the same kernels run in the same order whatever the split,
    so the logits stay bit-equal."""
    _, tr, tokens = pair
    inputs = {"tokens": torch.from_numpy(tokens)}
    mgr = PipelineManager(tr, split=1, net=NetworkModel(20.0),
                          sample_inputs=inputs, standby_split=2)
    ref, _ = mgr.serve(inputs)
    for strategy, split in STRATEGIES:
        rep = mgr.repartition(strategy, split)
        assert rep.new_split == split and mgr.active.split == split
        out, timing = mgr.serve(inputs)
        assert torch.equal(out, ref), strategy
        assert timing.t_edge > 0 and timing.t_cloud > 0
    mgr.close()


def test_downtime_ordering_and_memory(pair):
    """tests/test_pipeline_switching.py's ordering and Table I on the
    port's stateless pool: t(A) < t(B2) < t(pause_resume), only the
    baseline is a full outage that reloads weights, and a standby with its
    own weights doubles the memory.  Walls on a CPU shared with other test
    workers are read as the minimum over three rounds."""
    _, tr, tokens = pair
    inputs = {"tokens": torch.from_numpy(tokens)}
    mgr = PipelineManager(tr, split=1, net=NetworkModel(20.0),
                          sample_inputs=inputs, standby_split=2)
    m = mgr.memory_report()
    assert m["additional_bytes"] == pytest.approx(m["initial_bytes"],
                                                  rel=0.01)
    seen = {"switch_a": [], "switch_b2": [], "pause_resume": []}
    for round_ in range(3):
        if round_:
            mgr.build_standby(2)
        rep_a = mgr.repartition("switch_a", 2)
        rep_b2 = mgr.repartition("switch_b2", 0)
        rep_pr = mgr.repartition("pause_resume", 2)
        rep_b1 = mgr.repartition("switch_b1", 1)
        for rep in (rep_a, rep_b2, rep_pr):
            seen[rep.strategy].append(rep.downtime)
        assert rep_a.t_build == 0 and rep_a.build_detail is None
        assert rep_b2.build_detail.t_weights == 0
        assert rep_pr.full_outage and not rep_b1.full_outage
        assert not rep_a.full_outage and not rep_b2.full_outage
        assert rep_pr.build_detail.t_weights > 0
    best = {k: min(v) for k, v in seen.items()}
    assert best["switch_a"] < best["switch_b2"] < best["pause_resume"], best
    assert best["switch_a"] < 0.05
    mgr.close()
    shared = PipelineManager(tr, split=1, net=NetworkModel(20.0),
                             sample_inputs=inputs, standby_split=2,
                             standby_owns_weights=False)
    assert shared.memory_report()["additional_bytes"] == 0
    shared.close()


@pytest.fixture(scope="module")
def moe_pair():
    """Reduced qwen2-moe-a2.7b (2 layers of 4 experts top-2 and a shared
    expert) routed with the configured capacity factor 1.25, so the
    24-token request overflows experts: the same weights and prompt in both
    packages, each runner on its kernel route."""
    def cfg_of(get):
        cfg = get("qwen2-moe-a2.7b").reduced()
        return dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=1.25))
    cfg = cfg_of(get_config)
    params = JT.init_model(cfg, jax.random.PRNGKey(0))
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (1, SEQ))
    jr = JRunner(cfg, params, attn_impl="pallas")
    tr = StageRunner(cfg_of(tget), from_numpy(jax.tree.map(np.asarray,
                                                           params)),
                     attn_impl="kernel", device="cpu")
    return jr, tr, tokens


def test_moe_stage_runner_matches_jax_every_split(moe_pair):
    test_stage_runner_matches_jax_every_split(moe_pair)


def test_moe_switching_preserves_logits_every_strategy(moe_pair):
    test_switching_preserves_logits_every_strategy(moe_pair)


def _stateful_pair(**kw):
    cfg = dataclasses.replace(get_config("qwen2.5-3b").reduced(),
                              num_layers=3, num_kv_heads=2)
    tcfg = dataclasses.replace(tget("qwen2.5-3b").reduced(), num_layers=3,
                               num_kv_heads=2)
    params = JT.init_model(cfg, jax.random.PRNGKey(0))
    jm, js = jax_manager(cfg, params, split=1, net=JNet(20.0), prompt_len=8,
                         max_seq=32, decode_impl="reference", **kw)
    tm, ts = make_stateful_manager(
        tcfg, from_numpy(jax.tree.map(np.asarray, params)), split=1,
        net=NetworkModel(20.0), max_seq=32, decode_impl="reference",
        attn_impl="kernel", device="cpu", prompt=np.asarray(js.tokens), **kw)
    return (jm, js), (tm, ts)


def test_stateful_prefill_and_recompute_on_kernel_route():
    """``make_stateful_manager(attn_impl="kernel")`` puts the prefill and
    the recompute arm on the flash-attention route and still matches the
    JAX stream through recompute hand-offs."""
    (jm, js), (tm, ts) = _stateful_pair(standby_split=2,
                                        force_mode="recompute")
    assert tm.runner.attn_impl == "kernel"
    np.testing.assert_allclose(ts.last_logits.numpy(),
                               np.asarray(js.last_logits), atol=5e-5)
    for strategy, split in [(None, None), ("switch_b2", 0),
                            ("switch_a", 2)]:
        if strategy is not None:
            ja = jm.repartition(strategy, split)
            ta = tm.repartition(strategy, split)
            assert ta.handoff_mode == ja.handoff_mode == "recompute"
        for _ in range(2):
            tok = np.asarray(js.next_token())
            a, _ = jm.active.process({"token": tok})
            b, _ = tm.active.process({"token": tok})
            np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=5e-5,
                                       rtol=1e-3)
    before = {k: v.clone() for k, v in ts.cache.items()}
    ts.recompute_layers(0, 3)
    for k, v in ts.cache.items():
        np.testing.assert_allclose(v.numpy(), before[k].numpy(), atol=1e-4,
                                   err_msg=k)
    jm.close()
    tm.close()


def test_entry_points_need_cuda_unless_cpu(pair):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the defaults do not raise")
    _, tr, _ = pair
    with pytest.raises(RuntimeError, match="CUDA"):
        StageRunner(tr.cfg, tr.params)
    # every family is ported (ssm and hybrid: test_torch_ssm_serving; moe:
    # the MoE tests below; vlm and audio: test_torch_frontends): the
    # frontends build on the CPU, a family the reference lacks raises
    for arch in ("whisper-medium", "internvl2-76b"):
        cfg = tget(arch).reduced()
        assert StageRunner(cfg, init_model(cfg, device="cpu"),
                           device="cpu").num_units == cfg.num_layers + 2
    cfg = dataclasses.replace(tr.cfg, family="rnn")
    with pytest.raises(ValueError):
        StageRunner(cfg, tr.params, device="cpu")


def test_quickstart_torch_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable,
                          str(REPO / "examples" / "quickstart_torch.py"),
                          "--device", "cpu"], env=env, capture_output=True,
                         text=True, timeout=300, cwd=str(REPO))
    assert out.returncode == 0, out.stderr[-2000:]
    assert "same logits after repartition" in out.stdout
