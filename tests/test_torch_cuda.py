"""The port on a CUDA device: the flash-decode, flash-attention,
mamba1_scan and ssd_scan kernels against their plain versions (the
attention kernels at zamba2-7b's head_dim 112 too), short kernel-routed
decodes against the reference route for the dense, ssm and hybrid
families, and the stateless pipeline on the prefill kernel.
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
