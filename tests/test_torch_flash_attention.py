"""Port of flash_attention: the plain PyTorch version and
``attention(impl="kernel")`` against the JAX package's Pallas kernel
(interpret mode on the CPU) over the reference's shape grid and mask cases
and whisper's non-causal Sq != Sk shapes at D 64, the wrapper's refusals,
and its tile and grid plan.  The CUDA kernel itself is held against the
plain version in tests/test_torch_cuda.py and chip_smoke.py."""
import collections

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import \
    flash_attention as jax_flash_attention  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.models import layers as Lyr  # noqa: E402

# tests/test_kernels.py's shape grid and mask cases
SHAPES = [
    (1, 16, 16, 2, 2, 16),
    (2, 64, 64, 4, 2, 32),
    (1, 40, 40, 4, 4, 16),     # padding (40 % 16 != 0)
    (2, 32, 32, 8, 1, 64),     # MQA
    (1, 33, 65, 2, 2, 8),      # cross lengths + padding
]
MASKS = [(True, None, 0), (True, 48, 0), (False, 24, 0), (True, None, 7)]


def _tol(dtype):
    """tests/test_kernels.py's ``_tol``."""
    return 2e-2 if dtype == "bfloat16" else 1e-4


def _inputs(B, Sq, Sk, H, KH, D, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, D), dtype=np.float32),
            rng.standard_normal((B, Sk, KH, D), dtype=np.float32),
            rng.standard_normal((B, Sk, KH, D), dtype=np.float32))


def _both(arrays, dtype):
    """The same numbers in both frameworks (bf16 rounds identically)."""
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return ([jnp.asarray(a, jd) for a in arrays],
            [torch.from_numpy(a).to(td) for a in arrays])


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("B,Sq,Sk,H,KH,D", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_kernel_shapes(B, Sq, Sk, H, KH, D, dtype):
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(B, Sq, Sk, H, KH, D), dtype)
    want = jax_flash_attention(jq, jk, jv, causal=False, block_q=16,
                               block_k=16)
    got = FA.flash_attention_plain(tq, tk, tv, causal=False)
    assert got.dtype == tq.dtype and got.shape == (B, Sq, H, D)
    _close(got, want, _tol(dtype))
    routed = Lyr.attention(tq, tk, tv, causal=False, impl="kernel")
    assert torch.equal(routed, got)


@pytest.mark.parametrize("causal,window,q_offset", MASKS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_kernel_masks(causal, window, q_offset, dtype):
    B, Sq, H, KH, D = 2, 64, 4, 2, 32
    Sk = Sq + q_offset
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(B, Sq, Sk, H, KH, D, seed=1),
                                       dtype)
    want = jax_flash_attention(jq, jk, jv, causal=causal, window=window,
                               q_offset=q_offset, block_q=16, block_k=16)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    got = FA.flash_attention_plain(tq, tk, tv, **kw)
    _close(got, want, _tol(dtype))
    for impl in ("kernel", "pallas"):
        assert torch.equal(Lyr.attention(tq, tk, tv, impl=impl, **kw), got)


# whisper's cross attention and encoder: non-causal at D 64, Sq != Sk,
# a ragged key tail (44 = 2 * 16 + 12), Sq below, equal to and above Sk
CROSS_SHAPES = [(1, 20, 44, 4, 4, 64), (2, 12, 44, 2, 2, 64),
                (1, 70, 44, 4, 4, 64), (1, 44, 44, 4, 4, 64)]


@pytest.mark.parametrize("B,Sq,Sk,H,KH,D", CROSS_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_kernel_cross(B, Sq, Sk, H, KH, D, dtype):
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(B, Sq, Sk, H, KH, D, seed=3),
                                       dtype)
    want = jax_flash_attention(jq, jk, jv, causal=False, block_q=16,
                               block_k=16)
    got = FA.flash_attention_plain(tq, tk, tv, causal=False)
    assert got.dtype == tq.dtype and got.shape == (B, Sq, H, D)
    _close(got, want, _tol(dtype))
    assert torch.equal(Lyr.attention(tq, tk, tv, causal=False,
                                     impl="kernel"), got)
    if dtype == "float32":
        np.testing.assert_allclose(
            Lyr.chunked_attention(tq, tk, tv, causal=False, q_chunk=16,
                                  kv_chunk=16).numpy(), got.numpy(),
            atol=1e-5)


def test_non_causal_items_walk_every_key_tile():
    """Non-causal, every q tile walks all ``ceil(Sk / 64)`` key tiles,
    whatever Sq: whisper's encoder (1500 x 1500: 24 tiles, the last of 28
    keys) and cross attention (448 x 1500)."""
    for Sq, Sk in ((1500, 1500), (448, 1500), (20, 44)):
        for qt in range(FA.n_q_tiles(Sq)):
            assert FA.key_tiles(qt, Sq, Sk, causal=False, window=None,
                                q_offset=0) == (0, -(-Sk // FA.BLOCK_K))
    assert -(-1500 // FA.BLOCK_K) == 24 and 1500 - 23 * FA.BLOCK_K == 28
    q = torch.empty(1, 448, 16, 64)
    k = torch.empty(1, 1500, 16, 64)
    assert FA.live_pairs(448, 1500, causal=False, window=None,
                         q_offset=0) == 448 * 1500
    assert FA.bound_flops(q, k, causal=False) == 4 * 64 * 16 * 448 * 1500


@pytest.mark.parametrize("causal,window,q_offset", MASKS)
def test_plain_matches_chunked(causal, window, q_offset):
    """The port's two prefill routes agree (the stateful runner's default
    and its kernel route)."""
    B, Sq, H, KH, D = 1, 150, 4, 2, 16
    _, (tq, tk, tv) = _both(_inputs(B, Sq, Sq + q_offset, H, KH, D, seed=2),
                            "float32")
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    np.testing.assert_allclose(
        FA.flash_attention_plain(tq, tk, tv, **kw).numpy(),
        Lyr.chunked_attention(tq, tk, tv, q_chunk=64, kv_chunk=32,
                              **kw).numpy(), atol=1e-5)


def test_refusals():
    q, k, v = (torch.zeros(1, 8, 4, 16), torch.zeros(1, 8, 2, 16),
               torch.zeros(1, 8, 2, 16))
    with pytest.raises(TypeError):
        FA.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(TypeError):
        FA.flash_attention(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="multiple"):
        FA.flash_attention(torch.zeros(1, 8, 3, 16), k, v)
    with pytest.raises(ValueError):
        FA.flash_attention(q, k, v[:, :4])
    with pytest.raises(ValueError, match="window"):
        FA.flash_attention(q, k, v, window=0)
    with pytest.raises(ValueError, match="q_offset"):
        FA.flash_attention(q, k, v, q_offset=-1)
    # meta tensors (a dry run's shapes) give the output's shape and launch
    # nothing; a mix of devices is refused, not handed to the plain version
    before = FA.flash_attention.launches
    out = FA.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))
    assert out.is_meta and out.shape == q.shape
    assert FA.flash_attention.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        FA.flash_attention(q.to("meta"), k, v)
    # what the kernel itself refuses (checked before any launch)
    FA._check_launchable(q, k, v)
    for D in (24, 256):
        with pytest.raises(ValueError, match="head_dim"):
            FA._check_launchable(torch.zeros(1, 8, 4, D),
                                 torch.zeros(1, 8, 2, D),
                                 torch.zeros(1, 8, 2, D))
    with pytest.raises(ValueError, match="last dimension"):
        FA._check_launchable(torch.zeros(1, 8, 16, 4).transpose(2, 3), k, v)
    odd = torch.zeros(1, 8, 2, 18)[..., :16]        # rows 72 bytes apart
    with pytest.raises(ValueError, match="16 bytes"):
        FA._check_launchable(q, odd, v)
    with pytest.raises(ValueError, match="aligned"):
        FA._check_launchable(q, k, torch.zeros(1 * 8 * 2 * 16 + 1)[1:]
                             .reshape(1, 8, 2, 16))
    # strided views the kernel does take: a head-major tensor seen
    # sequence-major (the reference's layout copy is not needed)
    FA._check_launchable(q, torch.zeros(1, 2, 8, 16).transpose(1, 2), v)


def test_grid_and_tile_plan():
    # bf16: work items of 64 query rows, two a block; the served prefill's
    # 16 q tiles x 16 heads = 256 items in 128 blocks
    assert FA.grid_plan(1, 1024, 16) == (128,)
    assert FA.grid_plan(2, 33, 4) == (4,)
    assert FA.grid_plan(1, 40, 3) == (2,)            # an odd item count
    assert FA.block_items(1, 1, 40, 3) == [(0, 2, 0)]
    # items go longest causal tile first, a block's two are adjacent heads
    # of one q tile
    assert FA.work_items(1, 1024, 16)[:2] == [(0, 0, 15), (0, 1, 15)]
    assert FA.block_items(127, 1, 1024, 16) == [(0, 14, 0), (0, 15, 0)]
    assert FA.work_items(2, 33, 4)[:5] == [(0, 0, 0), (0, 1, 0), (0, 2, 0),
                                           (0, 3, 0), (1, 0, 0)]
    # f32: one block per (b, h) and q tile
    assert FA.grid_plan(1, 1024, 16, torch.float32) == (16, 16)
    assert FA.grid_plan(2, 33, 4, torch.float32) == (8, 1)
    # causal: q tile i walks key tiles [0, i] when Sq == Sk
    for i in range(16):
        assert FA.key_tiles(i, 1024, 1024, causal=True, window=None,
                            q_offset=0) == (0, i + 1)
    # non-causal walks every key tile; a ragged Sk rounds up
    assert FA.key_tiles(0, 33, 65, causal=False, window=None,
                        q_offset=0) == (0, 2)
    # a window starts at the tile of the first row's first live key
    assert FA.key_tiles(3, 256, 256, causal=True, window=48,
                        q_offset=0) == (2, 4)
    # q_offset shifts the causal limit
    assert FA.key_tiles(0, 64, 71, causal=True, window=None,
                        q_offset=7) == (0, 2)
    # the bound counts live pairs: S(S+1)/2 causal
    assert FA.live_pairs(1024, 1024, causal=True, window=None,
                         q_offset=0) == 1024 * 1025 // 2
    assert FA.live_pairs(64, 64, causal=False, window=24, q_offset=0) == sum(
        64 - max(0, i - 23) for i in range(64))
    q = torch.zeros(1, 1024, 16, 128, dtype=torch.bfloat16)
    k = torch.zeros(1, 1024, 2, 128, dtype=torch.bfloat16)
    assert FA.bound_flops(q, k) == 4 * 128 * 16 * 1024 * 1025 // 2
    assert FA.bound_bytes(q, k) == (2 * q.numel() + 2 * k.numel()) * 2


def test_walked_tiles_cover_every_live_key():
    """The kernel's loop bounds (key_tiles) skip no live key: every live
    (query, key) pair of the mask grid lies in a walked tile."""
    for causal, window, q_offset in MASKS + [(False, None, 0)]:
        Sq, Sk = 150, 150 + q_offset
        for qt in range(-(-Sq // FA.BLOCK_Q)):
            lo, hi = FA.key_tiles(qt, Sq, Sk, causal=causal, window=window,
                                  q_offset=q_offset)
            for i in range(qt * FA.BLOCK_Q, min(Sq, (qt + 1) * FA.BLOCK_Q)):
                qpos = q_offset + i
                for j in range(Sk):
                    live = (not causal or j <= qpos) and (
                        window is None or j > qpos - window)
                    if live:
                        assert lo <= j // FA.BLOCK_K < hi, (qt, i, j)


# the served prefill shapes (qwen2.5-3b, zamba2-7b's shared attention; the
# recompute arm's q_offset > 0, Sq < Sk) and the reference's grid
SCHEDULE_CASES = [(1, 1024, 1024, 16, True, None, 0),
                  (1, 2048, 2048, 16, True, None, 0),
                  (1, 2048, 2048, 32, True, None, 0),
                  (1, 1024, 2048, 16, True, None, 1024),
                  # whisper-medium's encoder, cross attention and decoder,
                  # internvl2-76b's prefill (256 patches + 768 tokens)
                  (1, 1500, 1500, 16, False, None, 0),
                  (1, 448, 1500, 16, False, None, 0),
                  (1, 448, 448, 16, True, None, 0),
                  (1, 1024, 1024, 64, True, None, 0)] + [
    (B, Sq, Sk, H, False, None, 0) for B, Sq, Sk, H, _, _ in SHAPES] + [
    (2, 64, 64 + q_offset, 4, causal, window, q_offset)
    for causal, window, q_offset in MASKS]


@pytest.mark.parametrize("B,Sq,Sk,H,causal,window,q_offset", SCHEDULE_CASES)
def test_schedule_covers_every_item_and_live_key_once(B, Sq, Sk, H, causal,
                                                      window, q_offset):
    """The bf16 launch runs every (b, h, q tile) exactly once, and each
    walks every live key of its rows exactly once (no kv split: one walk
    a q tile, over disjoint key tiles)."""
    n = -(-Sq // FA.BLOCK_Q)
    seen = collections.Counter()
    for x in range(FA.grid_plan(B, Sq, H)[0]):
        items = FA.block_items(x, B, Sq, H)
        assert 1 <= len(items) <= FA.CONSUMERS
        seen.update(items)
    assert set(seen) == {(b, h, qt) for b in range(B) for h in range(H)
                         for qt in range(n)}
    assert set(seen.values()) == {1}
    kpos = np.arange(Sk)
    for qt in range(n):
        lo, hi = FA.key_tiles(qt, Sq, Sk, causal=causal, window=window,
                              q_offset=q_offset)
        walked = np.zeros(Sk, np.int64)
        for kt in range(lo, hi):
            walked[kt * FA.BLOCK_K:(kt + 1) * FA.BLOCK_K] += 1
        qpos = q_offset + np.arange(qt * FA.BLOCK_Q,
                                    min(Sq, (qt + 1) * FA.BLOCK_Q))
        live = np.ones((len(qpos), Sk), bool)
        if causal:
            live &= kpos[None, :] <= qpos[:, None]
        if window is not None:
            live &= kpos[None, :] > qpos[:, None] - window
        assert (walked[live.any(0)] == 1).all(), qt
    chain, mean = FA.schedule_chain(B, Sq, Sk, H, causal=causal,
                                    window=window, q_offset=q_offset)
    assert chain >= mean > 0
