"""The plain reference against the port's own plain path at a tiny size,
on the same weights (the benchmark's, from the seed), in f32 on the CPU;
and the control's lower precision shows in the comparison."""
import pytest
import torch

from bench.harness.main import arch_config
from bench.harness.weights import make_weights
from bench.reference import control as C
from bench.reference import ssm as R
from bench.tests.tiny import PORTS

torch.set_num_threads(2)


@pytest.mark.parametrize("config", sorted(PORTS))
def test_reference_matches_the_port(config):
    from repro_torch.core.stages import StageRunner
    port = PORTS[config]
    params = make_weights(port, 11, "cpu", torch.float32)
    toks = torch.randint(0, port["vocab_size"], (80,),
                         generator=torch.Generator().manual_seed(3))
    runner = StageRunner(arch_config(port), params, attn_impl="kernel",
                         device="cpu")
    got = runner.run_units({"tokens": toks[None]}, 0,
                           runner.num_units)["logits"][0]
    ref = R.forward_logits(port, params, toks)
    scale = ref.abs().max()
    assert (got - ref).abs().max() <= 1e-4 * scale
    assert C.widest_gap(ref, got.argmax(-1)) <= 1e-4 * scale


@pytest.mark.parametrize("config", sorted(PORTS))
def test_control_departs(config):
    port = PORTS[config]
    params = make_weights(port, 12, "cpu", torch.float32)
    toks = torch.randint(0, port["vocab_size"], (64,),
                         generator=torch.Generator().manual_seed(4))
    ref = R.forward_logits(port, params, toks)
    low = R.forward_logits(port, params, toks, weight=C.low_precision)
    assert C.widest_gap(ref, low.argmax(-1)) > 1e-3 * ref.abs().max()


def test_scan_chunks_bound_the_decay():
    d = torch.tensor([100.0] * 20 + [1.0] * 200)
    bounds = R.chunk_bounds(d)
    assert bounds[0][0] == 0 and bounds[-1][1] == 220
    for a, b in bounds:
        assert b - a <= R.SCAN_CHUNK
        assert float(d[a:b].sum()) <= R.SCAN_LOG_LIMIT or b - a == 1
