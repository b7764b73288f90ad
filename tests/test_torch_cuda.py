"""The port on a CUDA device: the flash-decode, flash-attention,
mamba1_scan and ssd_scan kernels against their plain versions (the
attention kernels at zamba2-7b's head_dim 112, and at whisper-medium's
and internvl2-76b's full-width shapes, too), short kernel-routed
decodes against the reference route for the dense, moe, ssm, hybrid,
vlm and audio families and for the standalone ``decode_step`` on a
windowed ring, the
stateless pipeline on the prefill kernel, transfer hand-offs that
take no page-locked block from the host allocator, and the training
route: the chunked attention's backward against autograd through the
naive attention, and a train step on the card against the CPU's.
Imports only torch and the port, so it also runs where JAX is absent.
The sharded cloud stage's executor runs there too, both shards on the
card.  Every test here needs the card and skips without it:

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
from repro_torch.kernels import mamba_scan as MS  # noqa: E402
from repro_torch.kernels import ssd_scan as SD  # noqa: E402
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


# the served decode shapes: qwen2.5-3b (16 / 2 heads of 128) and zamba2-7b's
# shared attention (32 / 32 heads of 112), max_seq 2048
FD_FULL = [(16, 2, 128), (32, 32, 112)]
FD_SWEEP = (1, 15, 16, 17, 1025, 2047, 2048, 3000)


def _fd_inputs(cuda, B, H, KH, D, dtype, seed, S=2048):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return (torch.randn(B, 1, H, D, generator=g, device=cuda, dtype=dtype),
            torch.randn(B, KH, S, D, generator=g, device=cuda, dtype=dtype),
            torch.randn(B, KH, S, D, generator=g, device=cuda, dtype=dtype))


def _fd_hold(out, want):
    """f32 within 1e-4; bf16 within 1% of max|plain| (one rounding step,
    2**-7 of a value, at most)."""
    assert out.shape == want.shape and out.dtype == want.dtype
    tol = 1e-2 * want.float().abs().max().item() \
        if out.dtype == torch.bfloat16 else 1e-4
    err = (out.float() - want.float()).abs().max().item()
    assert err <= tol, (err, tol)


@pytest.mark.parametrize("H,KH,D", FD_FULL)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_full_width_pos_sweep(cuda, H, KH, D, dtype):
    """Every pos from one live key to past max_seq (clamped): the slices
    follow the live prefix, empty ones carry no weight."""
    q, k, v = _fd_inputs(cuda, 1, H, KH, D, dtype, seed=5)
    for pos in FD_SWEEP:
        pos_t = torch.tensor(pos, dtype=torch.int32, device=cuda)
        out = FD.flash_decode_attention(q, k, v, pos=pos_t)
        _fd_hold(out, FD.flash_decode_attention_plain(q, k, v, pos=pos_t))


@pytest.mark.parametrize("H,KH,D", FD_FULL)
def test_kernel_full_width_ragged_pos_and_repeat(cuda, H, KH, D):
    """Per-row pos at full width, a dead row among them (exact zeros), and
    two calls on the same inputs bit-equal (the merge's order is fixed)."""
    q, k, v = _fd_inputs(cuda, 4, H, KH, D, torch.bfloat16, seed=6)
    rows = torch.tensor([1025, 0, 17, 3000], dtype=torch.int32, device=cuda)
    out = FD.flash_decode_attention(q, k, v, pos=rows)
    _fd_hold(out, FD.flash_decode_attention_plain(q, k, v, pos=rows))
    assert torch.count_nonzero(out[1]) == 0
    again = FD.flash_decode_attention(q, k, v, pos=rows)
    assert torch.equal(out, again)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_slot_pool_shape_per_row_pos(cuda, dtype):
    """The slot pool's decode shape at qwen2.5-3b's full width: 4 slots,
    per-row pos with a dead row (exact zeros) and one at max_seq - 1."""
    q, k, v = _fd_inputs(cuda, 4, 16, 2, 128, dtype, seed=9)
    rows = torch.tensor([1024, 0, 2047, 37], dtype=torch.int32, device=cuda)
    out = FD.flash_decode_attention(q, k, v, pos=rows)
    _fd_hold(out, FD.flash_decode_attention_plain(q, k, v, pos=rows))
    assert torch.count_nonzero(out[1]) == 0


@pytest.mark.parametrize("H,KH,D", FD_FULL)
def test_kernel_consecutive_calls_reset_their_counters(cuda, H, KH, D):
    """64 calls in a row with changing pos, each held to the plain version:
    nothing a call leaves behind may change the next one."""
    q, k, v = _fd_inputs(cuda, 1, H, KH, D, torch.bfloat16, seed=7)
    g = torch.Generator().manual_seed(8)
    for i in range(64):
        pos = int(torch.randint(0, 2100, (1,), generator=g)) if i % 4 \
            else 1024 + i
        pos_t = torch.tensor(pos, dtype=torch.int32, device=cuda)
        out = FD.flash_decode_attention(q, k, v, pos=pos_t)
        _fd_hold(out, FD.flash_decode_attention_plain(q, k, v, pos=pos_t))


def test_kernel_replays_in_a_cuda_graph(cuda):
    """One call captured in a CUDA graph, replayed after pos is changed in
    place: the kernel reads pos on the device each replay."""
    q, k, v = _fd_inputs(cuda, 1, 16, 2, 128, torch.bfloat16, seed=9)
    pos_t = torch.tensor(1025, dtype=torch.int32, device=cuda)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):    # load and configure, uncaptured
        FD.flash_decode_attention(q, k, v, pos=pos_t)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = FD.flash_decode_attention(q, k, v, pos=pos_t)
    for pos in (1025, 1, 2048, 300, 0, 1040):
        pos_t.fill_(pos)
        graph.replay()
        torch.cuda.synchronize()
        _fd_hold(out, FD.flash_decode_attention_plain(q, k, v, pos=pos))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_admits_its_largest_head_dim(cuda, dtype):
    """The launch opt-ins, made once at an instantiation's first call,
    cover the largest head dim the wrapper admits (32 16-byte loads a
    row) at the widest cluster (16 splits), after a first small call."""
    for D in (16, 32 * (16 // torch.empty((), dtype=dtype).element_size())):
        q, k, v = _fd_inputs(cuda, 1, 8, 2, D, dtype, seed=10)
        assert FD.split_plan(1, 2, 2048, FD.row_tile(4)[1]) == 16
        pos_t = torch.tensor(1500, dtype=torch.int32, device=cuda)
        out = FD.flash_decode_attention(q, k, v, pos=pos_t)
        _fd_hold(out, FD.flash_decode_attention_plain(q, k, v, pos=pos_t))


def test_slot_pool_kernel_route_matches_reference_route(cuda):
    """A 4-slot pool on the card (ragged admissions, one mid-flight, per-row
    pos through the decode kernel, the masked admission through the
    prefill kernel) against the same pool on the reference routes."""
    from repro_torch.serving import make_session_manager
    cfg = dataclasses.replace(get_config("qwen2.5-3b").reduced(),
                              num_layers=2)
    params = init_model(cfg, device=cuda, seed=0)
    g = torch.Generator().manual_seed(3)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=g)
               for n in (9, 3, 17)]
    pools = []
    for attn, dec in (("kernel", "kernel"), ("chunked", "reference")):
        mgr, sm = make_session_manager(cfg, params, split=1,
                                       net=NetworkModel(1000.0), num_slots=4,
                                       max_seq=64, attn_impl=attn,
                                       decode_impl=dec, device=cuda)
        pools.append((mgr, sm))
    for (mgr, sm) in pools:
        sm.admit(prompts[0]), sm.admit(prompts[1])
    for step in range(4):
        if step == 2:
            for (_, sm) in pools:
                sm.admit(prompts[2])
        tok = pools[1][1].next_token()
        for (mgr, _) in pools:
            mgr.active.process({"token": tok})
        a, b = pools[0][1], pools[1][1]
        assert a.session_ids() == b.session_ids()
        for sid in b.session_ids():
            assert (a.logits_for(sid) - b.logits_for(sid)).abs().max() \
                .item() <= 1e-3, (step, sid)
    for (mgr, _) in pools:
        mgr.close()


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


def test_slot_pool_transfer_payload_round_trips_on_card(cuda):
    """A 4-slot pool's transfer payload on the card: every buffer is the
    page-locked host copy itself (read-only), its checksum is the
    envelope's, and the import lands the same state bit-exactly."""
    import zlib

    from repro_torch.core.stateful import (HANDOFF_META_KEY, HostBuffer,
                                           payload_checksum)
    from repro_torch.serving import make_session_manager
    cfg = dataclasses.replace(get_config("qwen2.5-3b").reduced(),
                              num_layers=2)
    mgr, sm = make_session_manager(cfg, split=1, net=NetworkModel(1000.0),
                                   num_slots=4, max_seq=64, device=cuda,
                                   force_mode="transfer")
    gen = torch.Generator().manual_seed(0)
    for i, n in enumerate((7, 3, 12)):
        sm.admit(torch.randint(0, cfg.vocab_size, (n,), generator=gen),
                 sid=f"s{i}")
    for _ in range(2):
        mgr.active.process({"token": sm.next_token()})
    before = {k: v.clone() for k, v in sm.cache.items()}
    payload, nbytes = sm.export_layers(0, cfg.num_layers)
    bufs = {k: v for k, v in payload.items() if k != HANDOFF_META_KEY}
    assert all(isinstance(b, HostBuffer) and b.tensor.is_pinned()
               and memoryview(b).readonly for _, _, b in bufs.values())
    assert nbytes == sum(len(b) for _, _, b in bufs.values())
    crc = 0
    for k in sorted(bufs, key=repr):
        dtype, shape, buf = bufs[k]
        crc = zlib.crc32(repr((k, dtype, tuple(shape))).encode(), crc)
        crc = zlib.crc32(bytes(buf), crc)
    assert crc == payload[HANDOFF_META_KEY][2] == payload_checksum(payload)
    sm.import_layers(payload)
    del payload, bufs
    torch.cuda.synchronize()
    for k, v in sm.cache.items():
        assert v.device.type == "cuda" and torch.equal(v, before[k]), k
    mgr.close()


def test_attention_kernels_at_head_dim_112(cuda):
    """zamba2-7b's shared attention: 32 heads of 112, MHA."""
    for dtype in (torch.float32, torch.bfloat16):
        _fa_compare(cuda, 1, 70, 70, 4, 4, 112, dtype, causal=True)
    _fa_compare(cuda, 1, 1024, 1024, 32, 32, 112, torch.bfloat16,
                causal=True)
    g = torch.Generator(device=cuda).manual_seed(4)
    q = torch.randn(1, 1, 32, 112, generator=g, device=cuda,
                    dtype=torch.bfloat16)
    k = torch.randn(1, 32, 2048, 112, generator=g, device=cuda,
                    dtype=torch.bfloat16)
    v = torch.randn(1, 32, 2048, 112, generator=g, device=cuda,
                    dtype=torch.bfloat16)
    for pos in (1, 1024, 2048):
        out = FD.flash_decode_attention(q, k, v, pos=pos)
        want = FD.flash_decode_attention_plain(q, k, v, pos=pos)
        tol = 1e-2 * want.float().abs().max().item()
        assert (out.float() - want.float()).abs().max().item() <= tol


@pytest.mark.parametrize("B,H,KH,D,dtype", [
    (1, 16, 2, 128, torch.bfloat16), (1, 32, 32, 112, torch.bfloat16),
    (4, 16, 2, 128, torch.float32), (4, 16, 2, 128, torch.bfloat16)])
def test_prefill_kernel_full_width_2048(cuda, B, H, KH, D, dtype):
    """At the served widths (qwen2.5-3b, zamba2-7b's shared attention) and
    the recompute arm's max_seq: 32 key tiles the last q tile, 512 and
    1024 (b, h, q tile) items; B 4 is a 4-slot pool's batch re-prefill."""
    _fa_compare(cuda, B, 2048, 2048, H, KH, D, dtype, causal=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prefill_kernel_recompute_shape(cuda, dtype):
    """The recompute arm's call: 300 queries at positions 1024 ... 1323
    against 1324 keys (q_offset > 0, Sq < Sk, a ragged last q tile)."""
    _fa_compare(cuda, 1, 300, 1324, 16, 2, 128, dtype, causal=True,
                q_offset=1024)


# tests/test_kernels.py's mamba-scan grid and tests/test_ssd_kernel.py's
# SSD grid, the full-width decode-step shapes, and ragged two-row cases at
# zamba2's head width (the chunk-parallel path) and for mamba1_scan (a
# ragged last chunk, and Di 37: element-wise loads, a ragged channel block)
MS_GRID = [(1, 16, 32, 8), (2, 32, 64, 16), (1, 70, 48, 8), (2, 100, 96, 16),
           (1, 1, 8192, 16), (2, 90, 37, 8)]
SSD_GRID = [(1, 32, 2, 16, 8), (2, 64, 4, 32, 16), (1, 50, 3, 8, 4),
            (2, 16, 1, 64, 32), (1, 1, 112, 64, 64), (2, 130, 2, 64, 64)]


def _hold(out, want, dtype):
    # bf16: 1% of max|plain|, one rounding step (2**-7 of a value) at most
    tol = 1e-2 * want.float().abs().max().item() \
        if dtype == torch.bfloat16 else 1e-4
    assert out.shape == want.shape and out.dtype == want.dtype
    assert (out.float() - want.float()).abs().max().item() <= tol


@pytest.mark.parametrize("B,S,Di,N", MS_GRID)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mamba_scan_kernel_matches_plain(cuda, B, S, Di, N, dtype):
    g = torch.Generator(device=cuda).manual_seed(5)

    def rand(*shape, dt=dtype):
        return torch.randn(shape, generator=g, device=cuda, dtype=dt)
    dt = torch.nn.functional.softplus(rand(B, S, Di, dt=torch.float32)) \
        .to(dtype)
    dbc = rand(B, S, 8 + 2 * N)          # B and C as column views
    args = (dt, dbc[..., 8:8 + N], dbc[..., 8 + N:], rand(B, S, Di),
            -torch.exp(rand(Di, N, dt=torch.float32) * 0.2))
    for h0 in (None, rand(B, Di, N, dt=torch.float32)):
        before = MS.mamba1_scan.launches
        y, h = MS.mamba1_scan(*args, h0=h0)
        torch.cuda.synchronize()
        assert MS.mamba1_scan.launches == before + 1
        yw, hw = MS.mamba1_scan_plain(*args, h0=h0)
        _hold(y, yw, dtype)
        _hold(h, hw, dtype)


@pytest.mark.parametrize("B,S,H,P,N", SSD_GRID)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_kernel_matches_plain(cuda, B, S, H, P, N, dtype):
    g = torch.Generator(device=cuda).manual_seed(6)

    def rand(*shape, dt=dtype):
        return torch.randn(shape, generator=g, device=cuda, dtype=dt)
    xbc = rand(B, S, H * P + 2 * N)      # x, B and C as column views
    args = (torch.nn.functional.softplus(rand(B, S, H, dt=torch.float32)),
            xbc[..., H * P:H * P + N], xbc[..., H * P + N:],
            xbc[..., :H * P].reshape(B, S, H, P),
            -torch.exp(rand(H, dt=torch.float32) * 0.3))
    for h0 in (None, rand(B, H, P, N, dt=torch.float32)):
        before = SD.ssd_scan.launches
        y, h = SD.ssd_scan(*args, h0=h0)
        torch.cuda.synchronize()
        assert SD.ssd_scan.launches == before + 1
        yw, hw = SD.ssd_scan_plain(*args, h0=h0)
        _hold(y, yw, dtype)
        _hold(h, hw, dtype)


@pytest.mark.parametrize("scan", ["mamba1", "ssd", "ssd_chunked",
                                  "mamba1_chunked"])
def test_scan_kernels_continue_and_freeze_under_masked_dt(cuda, scan):
    """[0:S] == [0:S/2] then [S/2:S] with carried h (1e-5), and dt = 0 past
    a live length leaves the state bit for bit as the live scan's."""
    g = torch.Generator(device=cuda).manual_seed(7)
    # the reference tests' continuation shapes, zamba2's head width over
    # four chunks (a chunk-aligned cut and live length), and mamba1 over
    # four chunks (a chunk-aligned cut, a live length inside a chunk)
    live = 20
    if scan == "mamba1":
        fn, shapes = MS.mamba1_scan, [(1, 32, 32), (1, 32, 8), (1, 32, 8),
                                      (1, 32, 32), (32, 8)]
    elif scan == "mamba1_chunked":
        fn, shapes = MS.mamba1_scan, [(1, 256, 64), (1, 256, 16),
                                      (1, 256, 16), (1, 256, 64), (64, 16)]
        live = 100
    elif scan == "ssd":
        fn, shapes = SD.ssd_scan, [(1, 32, 2), (1, 32, 4), (1, 32, 4),
                                   (1, 32, 2, 8), (2,)]
    else:
        fn, shapes = SD.ssd_scan, [(1, 256, 4), (1, 256, 64), (1, 256, 64),
                                   (1, 256, 4, 64), (4,)]
        live = 128
    dt, Bc, Cc, x, A = (torch.randn(s, generator=g, device=cuda)
                        for s in shapes)
    dt = torch.nn.functional.softplus(dt)
    A = -torch.exp(A * 0.2)
    S = dt.shape[1]
    y_full, h_full = fn(dt, Bc, Cc, x, A)
    y1, h1 = fn(dt[:, :S // 2], Bc[:, :S // 2], Cc[:, :S // 2],
                x[:, :S // 2], A)
    y2, h2 = fn(dt[:, S // 2:], Bc[:, S // 2:], Cc[:, S // 2:],
                x[:, S // 2:], A, h0=h1)
    assert (torch.cat([y1, y2], 1) - y_full).abs().max().item() <= 1e-5
    assert (h2 - h_full).abs().max().item() <= 1e-5
    masked = dt.clone()
    masked[:, live:] = 0
    _, h_pad = fn(masked, Bc, Cc, x, A)
    _, h_live = fn(masked[:, :live], Bc[:, :live], Cc[:, :live],
                   x[:, :live], A)
    assert torch.equal(h_pad, h_live)


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-7b"])
def test_ssm_kernel_route_matches_reference_route(cuda, arch):
    """Reduced ssm / hybrid models in f32: the prefill on the scan
    kernels, decode steps on the kernels (one scan launch a mamba layer,
    one flash-decode launch a shared-attention application) against the
    reference route's plain scans and decode attention."""
    cfg = dataclasses.replace(get_config(arch).reduced(), num_layers=4)
    kw = dict(split=2, net=NetworkModel(20.0), prompt_len=8, max_seq=64,
              device=cuda, attn_impl="kernel")
    km, ks = make_stateful_manager(cfg, decode_impl="auto", **kw)
    rm, rs = make_stateful_manager(cfg, decode_impl="reference", **kw)
    assert km.runner.resolved_decode_impl == "kernel"
    scan = MS.mamba1_scan if cfg.ssm.kind == "mamba1" else SD.ssd_scan
    apps = cfg.num_layers // cfg.hybrid_period if cfg.hybrid_period else 0
    for _ in range(4):
        tok = ks.next_token()
        before = (scan.launches, FD.flash_decode_attention.launches)
        a, _ = km.active.process({"token": tok})
        assert (scan.launches, FD.flash_decode_attention.launches) == \
            (before[0] + cfg.num_layers, before[1] + apps)
        b, _ = rm.active.process({"token": tok})
        assert (a - b).abs().max().item() <= 5e-4
    km.close()
    rm.close()


@pytest.mark.parametrize("S", [1, 64, 65, 1024])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ssd_scan_kernel_full_width(cuda, S, with_h0, dtype):
    """zamba2-7b's width (H 112, P 64, N 64) on both paths it takes: the
    decode step (S = 1) and the chunk-parallel launches (64: one chunk;
    65: a ragged second chunk; 1024: the served prompt)."""
    g = torch.Generator(device=cuda).manual_seed(8)
    H, P, N = 112, 64, 64

    def rand(*shape, dt=dtype):
        return torch.randn(shape, generator=g, device=cuda, dtype=dt)
    xbc = rand(1, S, H * P + 2 * N)
    args = (torch.nn.functional.softplus(rand(1, S, H, dt=torch.float32)),
            xbc[..., H * P:H * P + N], xbc[..., H * P + N:],
            xbc[..., :H * P].reshape(1, S, H, P),
            -torch.exp(rand(H, dt=torch.float32) * 0.3))
    h0 = rand(1, H, P, N, dt=torch.float32) if with_h0 else None
    before = SD.ssd_scan.launches
    y, h = SD.ssd_scan(*args, h0=h0)
    torch.cuda.synchronize()
    assert SD.ssd_scan.launches == before + 1
    yw, hw = SD.ssd_scan_plain(*args, h0=h0)
    _hold(y, yw, dtype)
    _hold(h, hw, dtype)


def _mamba_full_width(cuda, S, dtype, seed):
    """falcon-mamba-7b's layer (Di 8192, N 16; B and C column views of the
    x_proj output, dt_rank 256)."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    Di, N, R = 8192, 16, 256

    def rand(*shape, dt=dtype):
        return torch.randn(shape, generator=g, device=cuda, dtype=dt)
    dbc = rand(1, S, R + 2 * N)
    return (torch.nn.functional.softplus(rand(1, S, Di, dt=torch.float32))
            .to(dtype), dbc[..., R:R + N], dbc[..., R + N:], rand(1, S, Di),
            -torch.exp(rand(Di, N, dt=torch.float32) * 0.2))


@pytest.mark.parametrize("S", [1, 1024, 2048])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_mamba_scan_kernel_full_width(cuda, S, dtype):
    """Every launch plan at falcon-mamba-7b's width: the decode step (the
    output pass alone, from h0), the prompt and the recompute's max_seq
    (chunk states, carry, outputs)."""
    args = _mamba_full_width(cuda, S, dtype, 9)
    h0 = torch.randn(1, 8192, 16, device=cuda) if S == 1 else None
    before = MS.mamba1_scan.launches
    y, h = MS.mamba1_scan(*args, h0=h0)
    torch.cuda.synchronize()
    assert MS.mamba1_scan.launches == before + 1
    yw, hw = MS.mamba1_scan_plain(*args, h0=h0)
    _hold(y, yw, dtype)
    _hold(h, hw, dtype)


def test_mamba_scan_kernel_continues_across_chunks_at_full_width(cuda):
    """f32 over four chunks, cut at a chunk boundary: the second call from
    the first's state gives the whole call's y and h within 1e-5."""
    args = _mamba_full_width(cuda, 256, torch.float32, 10)
    cut = 2 * MS.CHUNK
    y_full, h_full = MS.mamba1_scan(*args)
    y1, h1 = MS.mamba1_scan(*(a[:, :cut] for a in args[:4]), args[4])
    y2, h2 = MS.mamba1_scan(*(a[:, cut:] for a in args[:4]), args[4], h0=h1)
    assert (torch.cat([y1, y2], 1) - y_full).abs().max().item() <= 1e-5
    assert (h2 - h_full).abs().max().item() <= 1e-5


@pytest.mark.parametrize("live", [1024, 1048])
def test_mamba_scan_kernel_masked_recompute_freezes(cuda, live):
    """The recompute arm's scan (max_seq 2048, bf16) with dt = 0 past a
    chunk-aligned live length and past the ragged one of a switch after
    24 decode steps: the state equals the live scan's bit for bit."""
    dt, Bc, Cc, x, A = _mamba_full_width(cuda, 2048, torch.bfloat16, 11)
    dt[:, live:] = 0
    _, h_pad = MS.mamba1_scan(dt, Bc, Cc, x, A)
    _, h_live = MS.mamba1_scan(dt[:, :live], Bc[:, :live], Cc[:, :live],
                               x[:, :live], A)
    assert torch.equal(h_pad, h_live)


@pytest.mark.parametrize("pool", ["decode_session", "slot_pool"])
@pytest.mark.parametrize("strategy", ["switch_b2", "switch_a"])
def test_transfer_switch_allocates_no_page_locked_block(cuda, pool,
                                                        strategy):
    """A stateful pool takes the page-locked blocks of its transfer
    exports when it is made (``warm_export``), and every export asks for
    an entry's block at its ``max_seq`` size: a transfer switch then grows
    the caching host allocator by no block (``num_host_alloc``)."""
    from repro_torch.serving import make_session_manager
    cfg = dataclasses.replace(get_config("qwen2.5-3b").reduced(),
                              num_layers=4)
    kw = dict(split=2, net=NetworkModel(1000.0), max_seq=64, device=cuda,
              force_mode="transfer")
    if pool == "slot_pool":
        mgr, s = make_session_manager(cfg, num_slots=4, **kw)
        gen = torch.Generator().manual_seed(0)
        for n in (7, 30):
            s.admit(torch.randint(0, cfg.vocab_size, (n,), generator=gen))
    else:
        mgr, s = make_stateful_manager(cfg, prompt_len=9, **kw)
    for split in (1, 3, 0):
        for _ in range(2):
            mgr.active.process({"token": s.next_token()})
        if strategy == "switch_a":
            mgr.build_standby(split)
        before = torch.cuda.host_memory_stats()["num_host_alloc"]
        rep = mgr.repartition(strategy, split)
        assert rep.handoff_mode == "transfer" and rep.handoff_bytes > 0
        assert torch.cuda.host_memory_stats()["num_host_alloc"] == before
        mgr.drain()
    mgr.close()


def test_moe_kernel_route_matches_reference_route(cuda):
    """Reduced qwen2-moe-a2.7b in f32 at the configured capacity factor
    1.25: the prefill on the flash-attention kernel and decode steps on the
    flash-decode kernel (one launch a layer) against the reference route,
    through a switch on each hand-off arm."""
    cfg = get_config("qwen2-moe-a2.7b").reduced()
    cfg = dataclasses.replace(cfg, num_layers=4, moe=dataclasses.replace(
        cfg.moe, capacity_factor=1.25))
    kw = dict(split=2, net=NetworkModel(20.0), prompt_len=24, max_seq=64,
              device=cuda, attn_impl="kernel")
    before = FA.flash_attention.launches
    km, ks = make_stateful_manager(cfg, decode_impl="auto", **kw)
    assert FA.flash_attention.launches == before + 2 * cfg.num_layers
    rm, rs = make_stateful_manager(cfg, decode_impl="reference", **kw)
    assert km.runner.resolved_decode_impl == "kernel"
    for arm, split in [(None, None), ("transfer", 1), ("recompute", 3)]:
        if arm is not None:
            for m in (km, rm):
                m.pool.force_mode = arm
                assert m.repartition("switch_b2", split).handoff_mode == arm
        for _ in range(3):
            tok = ks.next_token()
            before = FD.flash_decode_attention.launches
            a, _ = km.active.process({"token": tok})
            assert FD.flash_decode_attention.launches == \
                before + cfg.num_layers
            b, _ = rm.active.process({"token": tok})
            assert (a - b).abs().max().item() <= 5e-4
    km.close()
    rm.close()


@pytest.mark.parametrize("S", [5, 16, 13])
def test_standalone_decode_step_kernel_route_on_ring(cuda, S):
    """Reduced mixtral-8x22b in f32 with a window of 8: ``prefill`` on the
    flash-attention kernel (window 8) and ``decode_step`` on the
    flash-decode kernel over the 8-row ring, as it wraps, against the plain
    route (chunked attention, ``layers.decode_attention``) to 5e-4; one
    launch a layer each."""
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(get_config("mixtral-8x22b").reduced(),
                              sliding_window=8)
    params = init_model(cfg, device=cuda, seed=4)
    gen = torch.Generator().manual_seed(5)
    seq = torch.randint(0, cfg.vocab_size, (2, S + 10), generator=gen) \
        .to(cuda)
    before = FA.flash_attention.launches
    kl, kc = T.prefill(cfg, params, {"tokens": seq[:, :S]}, max_seq=64,
                       attn_impl="kernel")
    assert FA.flash_attention.launches == before + cfg.num_layers
    pl, pc = T.prefill(cfg, params, {"tokens": seq[:, :S]}, max_seq=64)
    assert kc["k"].shape[3] == 8
    assert (kl - pl).abs().max().item() <= 5e-4
    for n in range(S, S + 10):
        before = FD.flash_decode_attention.launches
        kl, kc = T.decode_step(cfg, params, seq[:, n:n + 1], kc,
                               attn_impl="kernel")
        assert FD.flash_decode_attention.launches == before + cfg.num_layers
        pl, pc = T.decode_step(cfg, params, seq[:, n:n + 1], pc)
        assert (kl - pl).abs().max().item() <= 5e-4


# whisper-medium (16 / 16 heads of 64) and internvl2-76b (64 / 8 of 128) at
# full width: whisper's encoder over its 1500 frames (the last key tile 28
# of 64 keys), its cross attention (448 queries against them) and its
# decoder, internvl2's 1024-row prefill
FRONTEND_FA = [(1500, 1500, 16, 16, 64, False), (448, 1500, 16, 16, 64, False),
               (448, 448, 16, 16, 64, True), (1024, 1024, 64, 8, 128, True)]


@pytest.mark.parametrize("Sq,Sk,H,KH,D,causal", FRONTEND_FA)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prefill_kernel_frontend_shapes(cuda, Sq, Sk, H, KH, D, causal,
                                        dtype):
    _fa_compare(cuda, 1, Sq, Sk, H, KH, D, dtype, causal=causal)


@pytest.mark.parametrize("Sq,Sk", [(20, 44), (70, 44), (64, 1500)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prefill_kernel_ragged_keys_non_causal(cuda, Sq, Sk, dtype):
    """Non-causal, Sq != Sk, a key tail short of a tile at D 64: the zero
    rows a TMA box reads past Sk must take no weight."""
    _fa_compare(cuda, 2, Sq, Sk, 4, 4, 64, dtype, causal=False)


@pytest.mark.parametrize("H,KH,D,S,sweep", [
    (16, 16, 64, 448, (1, 15, 16, 17, 200, 447, 448)),
    (64, 8, 128, 2048, (1, 17, 1024, 2048))])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_frontend_shapes(cuda, H, KH, D, S, sweep, dtype):
    """whisper-medium's decoder cache (no GQA, D 64, 448 rows) and
    internvl2-76b's (GQA 8), every pos of the sweep."""
    q, k, v = _fd_inputs(cuda, 1, H, KH, D, dtype, seed=9, S=S)
    for pos in sweep:
        pos_t = torch.tensor(pos, dtype=torch.int32, device=cuda)
        out = FD.flash_decode_attention(q, k, v, pos=pos_t)
        _fd_hold(out, FD.flash_decode_attention_plain(q, k, v, pos=pos_t))


@pytest.mark.parametrize("arch", ["whisper-medium", "internvl2-76b"])
def test_frontend_kernel_route_matches_plain_route(cuda, arch):
    """Reduced whisper-medium and internvl2-76b in f32: ``prefill`` (with
    the frames or patch embeddings) on the flash-attention kernel and four
    ``decode_step``s on the flash-decode kernel against the plain route to
    5e-4; the launches a prefill (whisper: encoder, self and cross
    attention each a layer) and a step; every ``StageRunner`` split on the
    kernel route bit-equal to its monolithic forward."""
    from repro_torch.models import transformer as T
    cfg = get_config(arch).reduced()
    params = init_model(cfg, device=cuda, seed=6)
    gen = torch.Generator().manual_seed(7)
    seq = torch.randint(0, cfg.vocab_size, (2, 14), generator=gen).to(cuda)
    inputs = {"tokens": seq[:, :10]}
    if cfg.frontend == "audio":
        inputs["frames"] = torch.randn(2, cfg.encoder.context_len,
                                       cfg.d_model, generator=gen).to(cuda)
        per_prefill = cfg.encoder.num_layers + 2 * cfg.num_layers
    else:
        inputs["vision_embeds"] = torch.randn(2, cfg.frontend_tokens,
                                              cfg.d_model,
                                              generator=gen).to(cuda)
        per_prefill = cfg.num_layers
    before = FA.flash_attention.launches
    kl, kc = T.prefill(cfg, params, inputs, max_seq=32, attn_impl="kernel")
    assert FA.flash_attention.launches == before + per_prefill
    pl, pc = T.prefill(cfg, params, inputs, max_seq=32)
    assert (kl - pl).abs().max().item() <= 5e-4
    for n in range(10, 14):
        before = FD.flash_decode_attention.launches
        kl, kc = T.decode_step(cfg, params, seq[:, n:n + 1], kc,
                               attn_impl="kernel")
        assert FD.flash_decode_attention.launches == before + cfg.num_layers
        pl, pc = T.decode_step(cfg, params, seq[:, n:n + 1], pc)
        assert (kl - pl).abs().max().item() <= 5e-4
    runner = StageRunner(cfg, params, attn_impl="kernel", device=cuda)
    mono = runner.run_units(inputs, 0, runner.num_units)["logits"]
    for split in range(runner.num_units - 1):
        mid = runner.run_units(inputs, 0, split + 1)
        out = runner.run_units(mid, split + 1, runner.num_units)["logits"]
        assert torch.equal(out, mono), split


# ---------------------------------------------------------------------------
# training: the chunked attention's backward and a train step on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,H,KH,D,window", [(300, 8, 2, 64, None),
                                             (700, 8, 8, 128, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chunked_attention_backward_matches_naive_autograd(cuda, S, H, KH,
                                                           D, window, dtype):
    """``attention(impl="chunked")``'s blockwise backward against autograd
    through ``naive_attention`` on the card (chunks of 128: ragged tails,
    the causal skip, the window's block skip).  f32: 1e-4 of each
    gradient's largest |value| (the reference's f32 attention tolerance);
    bf16: 2%, two bf16 roundings (of the saved output, which enters the
    backward's ``sum(dO * O)``, and of the result) of 2**-8 each."""
    from repro_torch.models import layers as Lyr
    g = torch.Generator(device=cuda).manual_seed(4)
    q, k, v = (torch.randn(2, S, h, D, generator=g, device=cuda, dtype=dtype)
               for h in (H, KH, KH))
    dout = torch.randn(2, S, H, D, generator=g, device=cuda, dtype=dtype)

    def grads(fn):
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = fn(*leaves)
        return [out] + list(torch.autograd.grad(out, leaves, dout))
    got = grads(lambda a, b, c: Lyr.chunked_attention(
        a, b, c, window=window, q_chunk=128, kv_chunk=128))
    want = grads(lambda a, b, c: Lyr.naive_attention(a, b, c, window=window))
    limit = 1e-4 if dtype == torch.float32 else 2e-2
    for name, x, y in zip(("out", "dq", "dk", "dv"), got, want):
        assert x.dtype == dtype, name
        err = (x.float() - y.float()).abs().max().item()
        assert err <= limit * y.float().abs().max().item(), (name, err)


def test_train_step_on_the_card_matches_the_cpu(cuda):
    """One reduced qwen2.5-3b ``make_train_step`` step in f32 on the card
    against the same step on the CPU from the same weights and batch: the
    loss and the grad norm to 1e-4.  AdamW's first step moves each element
    by about the rate, its sign the gradient's, so an element whose
    gradient is near rounding noise (the key bias's is zero in exact
    arithmetic) moves either way on either device.  Each element is held
    to 1e-6 plus ``lr * min(2, 2e-4 / r)``, ``r`` its CPU gradient's
    |value| over its leaf's largest: about 1e-6 where the gradient is
    large, twice the rate where the sign can flip (the devices' gradients
    held to 1e-4 of each leaf's largest, the reference's f32 tolerance)."""
    from repro_torch.core.stages import tree_leaves, tree_map
    from repro_torch.data import SyntheticTokens
    from repro_torch.models import transformer as T
    from repro_torch.training import make_train_step
    cfg = get_config("qwen2.5-3b").reduced()
    params = init_model(cfg, device="cpu", seed=8)
    batch = next(iter(SyntheticTokens(cfg, 2, 32, seed=9)))
    lr = 1e-4                                     # make_train_step's AdamW
    step, init_opt = make_train_step(cfg)
    live = tree_map(lambda t: t.detach().clone().requires_grad_(), params)
    loss, _ = T.train_loss(cfg, live, {k: torch.from_numpy(v)
                                       for k, v in batch.items()})
    found = iter(torch.autograd.grad(loss, tree_leaves(live),
                                     allow_unused=True))

    def limit(p):
        g = next(found)
        a = torch.zeros_like(p) if g is None else g.abs()
        r = a / a.max() if a.max() > 0 else a
        return 1e-6 + lr * torch.clamp(2e-4 / r, max=2.0)
    limits = tree_map(limit, params)
    out = {}
    for dev in ("cpu", cuda):
        p = _to(params, dev)
        b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        p, _, m = step(p, init_opt(p), b)
        out[str(dev)] = (_to(p, "cpu"), {k: v.item() for k, v in m.items()})
    (pc, mc), (pg, mg) = out["cpu"], out[str(cuda)]
    assert abs(mg["loss"] - mc["loss"]) <= 1e-4
    assert abs(mg["grad_norm"] - mc["grad_norm"]) <= 1e-4 * mc["grad_norm"]

    def leaves(a, b, lim, name=""):
        if isinstance(a, dict):
            for k in a:
                yield from leaves(a[k], b[k], lim[k], f"{name}/{k}")
        else:
            yield name, (a - b).abs(), lim
    for name, d, lim in leaves(pg, pc, limits):
        assert bool((d <= lim).all()), (name, (d / lim).max().item())


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device, copy=True)


# ---------------------------------------------------------------------------
# the sharded cloud stage: one shard's kernels, the executor on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_at_a_shards_shapes(cuda, dtype):
    """qwen2.5-3b's shard on a 2-way mesh: 8 query heads over the 1 KV head
    they read, D 128; flash_decode at pos 64 / 1024 / 2048 of a 2048-row
    cache, flash_attention causal at 1024 and 2048 rows."""
    q, k, v = _fd_inputs(cuda, 1, 8, 1, 128, dtype, seed=12, S=2048)
    for pos in (64, 1024, 2048):
        pos_t = torch.tensor(pos, dtype=torch.int32, device=cuda)
        out = FD.flash_decode_attention(q, k, v, pos=pos_t)
        _fd_hold(out, FD.flash_decode_attention_plain(q, k, v, pos=pos_t))
    for S in (1024, 2048):
        _fa_compare(cuda, 1, S, S, 8, 1, 128, dtype, causal=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_executor_on_the_card_matches_one_device(cuda, dtype):
    """Reduced qwen2.5-3b's cloud stage at tp 2 with both shards on the
    card (``set_mesh_devices``) against the single-device forward at every
    split (bf16: 1% of the largest logit; f32: 1e-4), each shard's
    attention on the kernels; in f32, a decode stream moved onto the mesh
    and back keeps the unswitched stream's tokens."""
    from repro_torch.core.pipeline import EdgeCloudPipeline
    from repro_torch.launch.mesh import reset_mesh_devices, set_mesh_devices
    cfg = get_config("qwen2.5-3b").reduced()
    params = init_model(cfg, device=cuda, dtype=dtype, seed=4)
    runner = StageRunner(cfg, params, attn_impl="kernel", device=cuda)
    gen = torch.Generator().manual_seed(5)
    inputs = {"tokens": torch.randint(0, cfg.vocab_size, (1, 64),
                                      generator=gen).to(cuda)}
    mono = runner.run_units(inputs, 0, runner.num_units)["logits"].float()
    tol = 1e-2 * mono.abs().max().item() if dtype == torch.bfloat16 \
        else 1e-4
    set_mesh_devices(["cuda:0"] * 2)
    try:
        for split in range(runner.num_units - 1):
            pipe = EdgeCloudPipeline(runner, split, NetworkModel(20.0),
                                     mesh_shape=(2,))
            pipe.build(inputs, cold=False)
            before = FA.flash_attention.launches
            got, _ = pipe.process(inputs)
            torch.cuda.synchronize()
            cloud = cfg.num_layers - split
            assert FA.flash_attention.launches == before + split + 2 * cloud
            assert (got.float() - mono).abs().max().item() <= tol, split
            pipe.close()
        if dtype == torch.bfloat16:
            return          # greedy tokens in bf16 can flip on a rounding
        kw = dict(split=1, net=NetworkModel(50.0), prompt_len=8,
                  max_seq=32, seed=3, device=cuda, dtype=dtype)
        mgr, sess = make_stateful_manager(cfg, **kw)
        for _ in range(6):
            mgr.serve(None)
        want = sess.tokens.clone()
        mgr.close()
        mgr, sess = make_stateful_manager(cfg, **kw)
        mgr.serve(None)
        mgr.set_mesh_shape((2,))
        assert mgr.repartition("switch_b2", 1).mesh_change
        before = FD.flash_decode_attention.launches
        for _ in range(3):
            mgr.serve(None)
        assert FD.flash_decode_attention.launches == before + 3 * (1 + 2)
        mgr.set_mesh_shape(None)
        assert mgr.repartition("switch_b2", 1).mesh_change
        for _ in range(2):
            mgr.serve(None)
        assert torch.equal(sess.tokens, want)
        mgr.close()
    finally:
        reset_mesh_devices()


# one shard's kernels on the 2-way mesh of the ssm, hybrid, moe and audio
# families: falcon-mamba-7b's 4096 of 8192 channels, zamba2-7b's 56 of 112
# Mamba-2 heads
@pytest.mark.parametrize("S", [1, 1024])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scans_at_a_shards_shapes(cuda, S, dtype):
    """mamba1_scan over a shard's 4096 channels (N 16) and ssd_scan over
    its 56 heads (P 64, N 64): a decode step from a state and the
    prompt."""
    g = torch.Generator(device=cuda).manual_seed(13)

    def rand(*shape, dt=dtype):
        return torch.randn(shape, generator=g, device=cuda, dtype=dt)
    Di, N = 4096, 16
    dbc = rand(1, S, 256 + 2 * N)
    args = (torch.nn.functional.softplus(rand(1, S, Di, dt=torch.float32))
            .to(dtype), dbc[..., 256:256 + N], dbc[..., 256 + N:],
            rand(1, S, Di), -torch.exp(rand(Di, N, dt=torch.float32) * 0.2))
    h0 = rand(1, Di, N, dt=torch.float32) if S == 1 else None
    y, h = MS.mamba1_scan(*args, h0=h0)
    yw, hw = MS.mamba1_scan_plain(*args, h0=h0)
    _hold(y, yw, dtype)
    _hold(h, hw, dtype)
    H, P, N = 56, 64, 64
    xbc = rand(1, S, H * P + 2 * N)
    args = (torch.nn.functional.softplus(rand(1, S, H, dt=torch.float32)),
            xbc[..., H * P:H * P + N], xbc[..., H * P + N:],
            xbc[..., :H * P].reshape(1, S, H, P),
            -torch.exp(rand(H, dt=torch.float32) * 0.3))
    h0 = rand(1, H, P, N, dt=torch.float32) if S == 1 else None
    y, h = SD.ssd_scan(*args, h0=h0)
    yw, hw = SD.ssd_scan_plain(*args, h0=h0)
    _hold(y, yw, dtype)
    _hold(h, hw, dtype)


# (H, KH, D, full-sequence calls (Sq, Sk, causal), decodes): zamba2-7b's
# shared attention (16 / 16 of 112), qwen2-moe-a2.7b's (8 / 8 of 128),
# whisper-medium's decoder and cross attention (8 / 8 of 64; stateless)
SHARD_ATTENTION = [(16, 16, 112, [(1024, 1024, True)], True),
                   (8, 8, 128, [(1024, 1024, True)], True),
                   (8, 8, 64, [(448, 448, True), (448, 1500, False)], False)]


@pytest.mark.parametrize("H,KH,D,calls,decodes", SHARD_ATTENTION)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_at_the_new_shards_shapes(cuda, H, KH, D, calls, decodes,
                                            dtype):
    if decodes:
        q, k, v = _fd_inputs(cuda, 1, H, KH, D, dtype, seed=14, S=2048)
        for pos in (64, 1024, 2048):
            pos_t = torch.tensor(pos, dtype=torch.int32, device=cuda)
            _fd_hold(FD.flash_decode_attention(q, k, v, pos=pos_t),
                     FD.flash_decode_attention_plain(q, k, v, pos=pos_t))
    for Sq, Sk, causal in calls:
        _fa_compare(cuda, 1, Sq, Sk, H, KH, D, dtype, causal=causal)


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-7b"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mamba_layers_on_the_mesh_match_one_device(cuda, arch, dtype):
    """Reduced falcon-mamba-7b (channel-parallel Mamba-1) and zamba2-7b
    (head-parallel Mamba-2 and its shared block) with their cloud stage at
    tp 2 on ``["cuda:0", "cuda:0"]`` against one device's forward at every
    split (bf16: 1% of the largest logit; f32: 1e-4), the scans on the
    kernels; in f32, a decode stream moved onto the mesh and back keeps
    the unswitched stream's tokens, its scans on the kernels."""
    from repro_torch.core.pipeline import EdgeCloudPipeline
    from repro_torch.launch.mesh import reset_mesh_devices, set_mesh_devices
    cfg = get_config(arch).reduced()
    scan = MS.mamba1_scan if cfg.ssm.kind == "mamba1" else SD.ssd_scan
    params = init_model(cfg, device=cuda, dtype=dtype, seed=4)
    runner = StageRunner(cfg, params, attn_impl="kernel", device=cuda)
    gen = torch.Generator().manual_seed(5)
    inputs = {"tokens": torch.randint(0, cfg.vocab_size, (1, 64),
                                      generator=gen).to(cuda)}
    mono = runner.run_units(inputs, 0, runner.num_units)["logits"].float()
    tol = 1e-2 * mono.abs().max().item() if dtype == torch.bfloat16 \
        else 1e-4
    set_mesh_devices(["cuda:0"] * 2)
    try:
        for split in range(runner.num_units - 1):
            pipe = EdgeCloudPipeline(runner, split, NetworkModel(20.0),
                                     mesh_shape=(2,))
            pipe.build(inputs, cold=False)
            before = scan.launches
            got, _ = pipe.process(inputs)
            torch.cuda.synchronize()
            cloud = cfg.num_layers - split
            assert scan.launches == before + split + 2 * cloud
            assert (got.float() - mono).abs().max().item() <= tol, split
            pipe.close()
        if dtype == torch.bfloat16:
            return          # greedy tokens in bf16 can flip on a rounding
        kw = dict(split=1, net=NetworkModel(50.0), prompt_len=8,
                  max_seq=32, seed=3, device=cuda, dtype=dtype)
        mgr, sess = make_stateful_manager(cfg, **kw)
        for _ in range(6):
            mgr.serve(None)
        want = sess.tokens.clone()
        mgr.close()
        mgr, sess = make_stateful_manager(cfg, **kw)
        mgr.serve(None)
        mgr.set_mesh_shape((2,))
        assert mgr.repartition("switch_b2", 1).mesh_change
        before = scan.launches
        for _ in range(3):
            mgr.serve(None)
        assert scan.launches == before + 3 * (1 + 2)
        mgr.set_mesh_shape(None)
        assert mgr.repartition("switch_b2", 1).mesh_change
        for _ in range(2):
            mgr.serve(None)
        assert torch.equal(sess.tokens, want)
        mgr.close()
    finally:
        reset_mesh_devices()


# -- decode stages as CUDA graphs (core/graphs.py) -------------------------

def _eager(mgr):
    """Take the stage graphs off every pipeline of ``mgr``'s pool: its
    steps run the eager callables, the twin a graphed pool is held to."""
    for key in list(mgr.pool.keys()):
        entry = mgr.pool.get(key)
        if entry is not None:
            entry.pipeline.graphs = None


def _traced(fn):
    """``fn()`` with the span recorder on."""
    from repro_torch.core import timing
    timing.tracing(True)
    try:
        return fn()
    finally:
        timing.tracing(False)


KERNELS = (MS.mamba1_scan, SD.ssd_scan, FD.flash_decode_attention,
           FA.flash_attention)


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-7b"])
def test_graphed_pool_steps_equal_eager_steps(cuda, arch):
    """A reduced ssm / hybrid 4-slot pool in bf16 whose decode stages are
    CUDA graphs, against its twin on the eager callables, over 64 steps
    through admissions, evictions, a readmission, a switch_b2 on the
    recompute arm, a switch_a on the transfer arm (its standby re-armed on
    the build thread while the pool steps) and an entry rebound by hand:
    every step's logits, launches and the final state bit-equal; every
    stage run a replay (``graph_eager`` 0), a capture at each served
    pipeline's first step and at the rebound entry's stage only, none
    inside a repartition; ``warm`` binds no graph."""
    from repro_torch.core import timing
    from repro_torch.serving import make_session_manager
    cfg = dataclasses.replace(get_config(arch).reduced(), num_layers=4)
    params = init_model(cfg, device=cuda, dtype=torch.bfloat16, seed=2)
    kw = dict(split=2, net=NetworkModel(1000.0), num_slots=4, max_seq=128,
              attn_impl="kernel", device=cuda)
    gm, g = make_session_manager(cfg, params, **kw)
    em, e = make_session_manager(cfg, params, **kw)
    gen = torch.Generator().manual_seed(6)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=gen)
               for n in (9, 20, 5, 14, 30)]

    def both(op):
        a = _traced(lambda: op(gm, g))
        _eager(em)
        b = op(em, e)
        return a, b

    def switch(strategy, split, arm):
        def op(m, s):
            if strategy == "switch_a":
                m.build_standby(split)
            m.pool.force_mode = arm
            rep = m.repartition(strategy, split)
            assert rep.handoff_mode == arm
        return op

    def rebind(m, s):
        if s is g:          # one entry of the cloud stage moves
            k = sorted(s.subset(m.active._u_edge, m.active._u_all))[0]
            s.cache[k] = s.cache[k].clone()

    events = {
        10: lambda m, s: s.evict("s0"),
        14: lambda m, s: s.admit(prompts[3], sid="s3"),
        20: lambda m, s: s.evict("s1"),
        22: lambda m, s: s.readmit("s0"),
        30: switch("switch_b2", 1, "recompute"),
        44: switch("switch_a", 3, "transfer"),
        50: rebind,
        52: lambda m, s: s.evict("s2"),
        54: lambda m, s: s.admit(prompts[4], sid="s4"),
    }
    timing.take_spans()
    timing.take_counts()
    for i, p in enumerate(prompts[:3]):
        both(lambda m, s: s.admit(p, sid=f"s{i}"))
    served = set()
    for i in range(64):
        if i in events:
            both(events[i])
        tok = e.next_token()
        # a re-armed standby's build launches kernels on the build thread
        building = gm.pool.pending_builds() or em.pool.pending_builds()
        before = [k.launches for k in KERNELS]
        _traced(lambda: gm.active.process({"token": tok}))
        mid = [k.launches for k in KERNELS]
        served.add(id(gm.active))
        _eager(em)
        em.active.process({"token": tok})
        after = [k.launches for k in KERNELS]
        if not building:
            assert [b - a for a, b in zip(before, mid)] == \
                [b - a for a, b in zip(mid, after)], i
            assert mid != before, i
        assert torch.equal(g.last_logits, e.last_logits), i
    gm.active.warm()
    tok = e.next_token()
    _traced(lambda: gm.active.process({"token": tok}))
    _eager(em)
    em.active.process({"token": tok})
    assert torch.equal(g.last_logits, e.last_logits)
    gm.drain()
    em.drain()
    counts, spans = timing.take_counts(), timing.take_spans()
    assert counts["graph_replays"] == 2 * 65
    assert "graph_eager" not in counts
    assert counts["graph_captures"] == 2 * len(served) + 1
    captures = [s for s in spans if s["name"] == "step.capture"]
    switches = [s for s in spans if s["name"] == "switch"]
    assert len(captures) == counts["graph_captures"] and len(switches) == 2
    assert not any(c["start"] < w["end"] and w["start"] < c["end"]
                   for c in captures for w in switches)
    for k, v in g.cache.items():
        assert torch.equal(v, e.cache[k]), k
    for sid in e.session_ids():
        assert torch.equal(g.tokens_for(sid), e.tokens_for(sid)), sid
    standby = gm.pool.get(gm.pool.standby_key).pipeline
    standby.warm()
    assert all(x.graph is None for x in standby.graphs)
    gm.close()
    em.close()


def test_mesh_stages_stay_eager_and_a_refused_capture_runs_eagerly(cuda):
    """Reduced qwen2.5-3b (f32) behind a ``DecodeSession``: moved onto a
    2-way mesh (both shards on the card) its steps run the eager callables
    (``graph_eager`` 2 a step, no replay), and back on one device the
    stages are captured again; a stage whose capture meets a host sync is
    refused and runs eagerly from then on, its logits equal to an eager
    twin's, and a later pipeline still captures and replays."""
    from repro_torch.core import timing
    from repro_torch.launch.mesh import reset_mesh_devices, set_mesh_devices
    cfg = dataclasses.replace(get_config("qwen2.5-3b").reduced(),
                              num_layers=4, num_kv_heads=2)
    kw = dict(split=2, net=NetworkModel(50.0), prompt_len=8, max_seq=64,
              seed=3, device=cuda)
    mgr, s = make_stateful_manager(cfg, **kw)
    tm, t = make_stateful_manager(cfg, **kw)

    def step():
        tok = t.next_token()
        _traced(lambda: mgr.serve({"token": tok}))
        _eager(tm)
        tm.serve({"token": tok})
        assert torch.equal(s.last_logits, t.last_logits)
        return timing.take_counts()

    timing.take_counts()
    assert step()["graph_captures"] == 2
    set_mesh_devices(["cuda:0"] * 2)
    try:
        for m in (mgr, tm):
            m.set_mesh_shape((2,))
            assert m.repartition("switch_b2", 1).mesh_change
        assert mgr.active.graphs is None
        for _ in range(2):
            c = step()
            assert c.get("graph_eager") == 2 and "graph_replays" not in c
        for m in (mgr, tm):
            m.set_mesh_shape(None)
            assert m.repartition("switch_b2", 1).mesh_change
        c = step()
        assert c["graph_captures"] == 2 and c["graph_replays"] == 2
    finally:
        reset_mesh_devices()
    r = mgr.runner
    real = r._make_decode_fn

    def syncing(u0, u1, in_place=False):
        fn = real(u0, u1, in_place)

        def run(params, x, cache, pos):
            if in_place:
                pos.max().item()        # a host sync: no capture
            return fn(params, x, cache, pos)
        return run
    r._make_decode_fn = syncing
    try:
        for m in (mgr, tm):
            assert m.repartition("switch_b2", 3).handoff_mode != "none"
        c = step()
        assert c["graph_captures"] == 2 and c["graph_eager"] == 2
        assert all(g.refused for g in mgr.active.graphs)
        c = step()
        assert c["graph_eager"] == 2 and "graph_captures" not in c
    finally:
        del r._make_decode_fn
    for m in (mgr, tm):
        m.repartition("switch_b2", 2)
    for _ in range(2):
        c = step()
    assert c["graph_replays"] == 2 and "graph_eager" not in c
    mgr.close()
    tm.close()
