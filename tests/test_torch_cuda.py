"""The port on a CUDA device: the flash-decode kernel against its plain
version, and a short kernel-routed decode against the reference route.
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
from repro_torch.kernels import flash_decode as FD  # noqa: E402

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
