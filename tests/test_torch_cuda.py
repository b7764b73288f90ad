"""The port on a CUDA device: the flash-decode and flash-attention kernels
against their plain versions, a short kernel-routed decode against the
reference route, and the stateless pipeline on the prefill kernel.
Imports only torch and the port, so it also runs where JAX is absent.
Every test here needs the card and skips without it:

    python -m pytest -m requires_cuda tests/test_torch_cuda.py
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.network import NetworkModel  # noqa: E402
from repro_torch.core.stateful import make_stateful_manager  # noqa: E402
from repro_torch.core.stages import StageRunner  # noqa: E402
from repro_torch.core.switching import PipelineManager  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import flash_decode as FD  # noqa: E402
from repro_torch.models.transformer import init_model  # noqa: E402

pytestmark = pytest.mark.requires_cuda

GRID = [(2, 8, 2, 64, 32, 40), (1, 4, 4, 100, 16, 100),
        (2, 16, 8, 128, 64, 1), (1, 2, 1, 48, 8, 17),
        (2, 8, 2, 256, 32, 200), (1, 16, 2, 2048, 128, 1024)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("B,H,KH,S,D,pos", GRID)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain(cuda, B, H, KH, S, D, pos, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn(B, 1, H, D, generator=g, device=cuda, dtype=dtype)
    k = torch.randn(B, KH, S, D, generator=g, device=cuda, dtype=dtype)
    v = torch.randn(B, KH, S, D, generator=g, device=cuda, dtype=dtype)
    pos_t = torch.tensor(pos, dtype=torch.int32, device=cuda)
    before = FD.flash_decode_attention.launches
    out = FD.flash_decode_attention(q, k, v, pos=pos_t)
    torch.cuda.synchronize()
    assert FD.flash_decode_attention.launches == before + 1
    want = FD.flash_decode_attention_plain(q, k, v, pos=pos_t)
    # bf16: 1% of max|plain|, one rounding step (2**-7 of a value) at most
    tol = 1e-2 * want.float().abs().max().item() \
        if dtype == torch.bfloat16 else 1e-4
    assert (out.float() - want.float()).abs().max().item() <= tol


def test_kernel_per_row_zero_and_size1(cuda):
    g = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn(4, 1, 4, 16, generator=g, device=cuda)
    k = torch.randn(4, 2, 64, 16, generator=g, device=cuda)
    v = torch.randn(4, 2, 64, 16, generator=g, device=cuda)
    rows = torch.tensor([40, 1, 0, 64], dtype=torch.int32, device=cuda)
    out = FD.flash_decode_attention(q, k, v, pos=rows)
    want = FD.flash_decode_attention_plain(q, k, v, pos=rows)
    assert (out - want).abs().max().item() <= 1e-4
    assert torch.count_nonzero(out[2]) == 0
    a = FD.flash_decode_attention(q[:1], k[:1], v[:1], pos=33)
    b = FD.flash_decode_attention(
        q[:1], k[:1], v[:1],
        pos=torch.tensor([33], dtype=torch.int32, device=cuda))
    assert torch.equal(a, b)
    with pytest.raises(ValueError):
        FD.flash_decode_attention(q, k.transpose(2, 3).contiguous()
                                  .transpose(2, 3), v, pos=rows)


def test_kernel_route_matches_reference_route(cuda):
    cfg = dataclasses.replace(get_config("qwen2.5-3b").reduced(),
                              num_layers=3, num_kv_heads=2)
    kw = dict(split=1, net=NetworkModel(20.0), prompt_len=8, max_seq=64,
              device=cuda)
    km, ks = make_stateful_manager(cfg, decode_impl="auto", **kw)
    rm, rs = make_stateful_manager(cfg, decode_impl="reference", **kw)
    assert km.runner.resolved_decode_impl == "kernel"
    for _ in range(4):
        tok = ks.next_token()
        before = FD.flash_decode_attention.launches
        a, _ = km.active.process({"token": tok})
        assert FD.flash_decode_attention.launches == before + cfg.num_layers
        b, _ = rm.active.process({"token": tok})
        assert (a - b).abs().max().item() <= 5e-4
    km.close()
    rm.close()


# tests/test_kernels.py's shape grid (non-causal) and mask cases, and the
# served prefill shape
FA_SHAPES = [(1, 16, 16, 2, 2, 16), (2, 64, 64, 4, 2, 32),
             (1, 40, 40, 4, 4, 16), (2, 32, 32, 8, 1, 64),
             (1, 33, 65, 2, 2, 8)]
FA_MASKS = [(True, None, 0), (True, 48, 0), (False, 24, 0), (True, None, 7)]


def _fa_compare(cuda, B, Sq, Sk, H, KH, D, dtype, **kw):
    g = torch.Generator(device=cuda).manual_seed(2)
    q = torch.randn(B, Sq, H, D, generator=g, device=cuda, dtype=dtype)
    k = torch.randn(B, Sk, KH, D, generator=g, device=cuda, dtype=dtype)
    v = torch.randn(B, Sk, KH, D, generator=g, device=cuda, dtype=dtype)
    before = FA.flash_attention.launches
    out = FA.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert FA.flash_attention.launches == before + 1
    want = FA.flash_attention_plain(q, k, v, **kw)
    # bf16: 1% of max|plain|, one rounding step (2**-7 of a value) at most
    tol = 1e-2 * want.float().abs().max().item() \
        if dtype == torch.bfloat16 else 1e-4
    assert out.shape == want.shape and out.dtype == dtype
    assert (out.float() - want.float()).abs().max().item() <= tol


@pytest.mark.parametrize("B,Sq,Sk,H,KH,D", FA_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prefill_kernel_matches_plain_shapes(cuda, B, Sq, Sk, H, KH, D,
                                             dtype):
    _fa_compare(cuda, B, Sq, Sk, H, KH, D, dtype, causal=False)


@pytest.mark.parametrize("causal,window,q_offset", FA_MASKS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prefill_kernel_matches_plain_masks(cuda, causal, window, q_offset,
                                            dtype):
    _fa_compare(cuda, 2, 64, 64 + q_offset, 4, 2, 32, dtype, causal=causal,
                window=window, q_offset=q_offset)


def test_prefill_kernel_full_width_and_strided(cuda):
    _fa_compare(cuda, 1, 1024, 1024, 16, 2, 128, torch.bfloat16,
                causal=True)
    # k/v as sequence-major views of heads-major tensors: strides, no copy
    g = torch.Generator(device=cuda).manual_seed(3)
    q = torch.randn(1, 100, 16, 128, generator=g, device=cuda)
    k = torch.randn(1, 2, 100, 128, generator=g, device=cuda)
    v = torch.randn(1, 2, 100, 128, generator=g, device=cuda)
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    out = FA.flash_attention(q, kt, vt)
    want = FA.flash_attention_plain(q, kt, vt)
    assert (out - want).abs().max().item() <= 1e-4
    with pytest.raises(ValueError):
        FA.flash_attention(q, kt, vt[..., :64].contiguous())
    with pytest.raises(ValueError, match="head_dim"):
        FA.flash_attention(q[..., :96], kt[..., :96], vt[..., :96])


def test_stateless_pipeline_on_prefill_kernel(cuda):
    cfg = get_config("qwen2.5-3b").reduced()
    runner = StageRunner(cfg, init_model(cfg, device=cuda),
                         attn_impl="kernel", device=cuda)
    tokens = {"tokens": torch.randint(0, cfg.vocab_size, (1, 48),
                                      device=cuda)}
    mgr = PipelineManager(runner, split=1, net=NetworkModel(20.0),
                          sample_inputs=tokens, standby_split=2)
    before = FA.flash_attention.launches
    ref, _ = mgr.serve(tokens)
    assert FA.flash_attention.launches == before + cfg.num_layers
    plain = StageRunner(cfg, runner.params, device=cuda)
    want = plain.run_units(tokens, 0, plain.num_units)["logits"]
    assert (ref - want).abs().max().item() <= 1e-4
    for strategy, split in [("switch_b2", 0), ("switch_a", 2),
                            ("pause_resume", 1)]:
        mgr.repartition(strategy, split)
        out, _ = mgr.serve(tokens)
        assert torch.equal(out, ref), strategy
    mgr.close()
