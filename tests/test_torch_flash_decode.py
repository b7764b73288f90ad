"""Port of flash_decode_attention: the plain PyTorch version against the
JAX package's Pallas kernel (interpret mode on the CPU), the wrapper's
refusals, and the split plan.  The CUDA kernel itself is held against the
plain version in tests/test_torch_cuda.py and chip_smoke.py."""
import numpy as np
import pytest

try:
    import hypothesis
    import hypothesis.strategies as st
except ImportError:
    from _hypothesis_compat import hypothesis, st

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_decode import \
    flash_decode_attention as jax_flash_decode  # noqa: E402
from repro_torch.kernels import flash_decode as FD  # noqa: E402

# tests/test_flash_decode.py's grid
GRID = [
    (2, 8, 2, 64, 32, 40, 16),
    (1, 4, 4, 100, 16, 100, 32),
    (2, 16, 8, 128, 64, 1, 16),
    (1, 2, 1, 48, 8, 17, 16),
    (2, 8, 2, 256, 32, 200, 128),
]
TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def _inputs(B, H, KH, S, D, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, 1, H, D), dtype=np.float32),
            rng.standard_normal((B, KH, S, D), dtype=np.float32),
            rng.standard_normal((B, KH, S, D), dtype=np.float32))


def _both(arrays, dtype):
    """The same numbers in both frameworks (bf16 rounds identically)."""
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return ([jnp.asarray(a, jd) for a in arrays],
            [torch.from_numpy(a).to(td) for a in arrays])


@pytest.mark.parametrize("B,H,KH,S,D,pos,bk", GRID)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_kernel(B, H, KH, S, D, pos, bk, dtype):
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(B, H, KH, S, D), dtype)
    want = jax_flash_decode(jq, jk, jv, pos=pos, block_k=bk)
    got = FD.flash_decode_attention_plain(tq, tk, tv, pos=pos)
    assert got.dtype == tq.dtype and got.shape == (B, 1, H, D)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=TOL[dtype])


def test_per_row_pos_and_dead_rows_zero():
    B, H, KH, S, D = 4, 4, 2, 64, 16
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(B, H, KH, S, D, seed=3),
                                       "float32")
    rows = [40, 1, 0, 64]
    want = jax_flash_decode(jq, jk, jv, pos=jnp.asarray(rows, jnp.int32),
                            block_k=16)
    got = FD.flash_decode_attention_plain(
        tq, tk, tv, pos=torch.tensor(rows, dtype=torch.int32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    assert torch.count_nonzero(got[2]) == 0          # pos == 0: exact zeros


def test_scalar_pos_zero_gives_zeros():
    _, (tq, tk, tv) = _both(_inputs(2, 4, 2, 32, 16), "float32")
    out = FD.flash_decode_attention_plain(tq, tk, tv, pos=0)
    assert torch.count_nonzero(out) == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_size1_vector_equals_scalar_bitwise(dtype):
    _, (tq, tk, tv) = _both(_inputs(1, 4, 2, 64, 16, seed=4), dtype)
    a = FD.flash_decode_attention(tq, tk, tv, pos=33)
    b = FD.flash_decode_attention(tq, tk, tv,
                                  pos=torch.tensor([33], dtype=torch.int32))
    assert torch.equal(a, b)


def test_cpu_wrapper_is_the_plain_version_and_launches_nothing():
    _, (tq, tk, tv) = _both(_inputs(2, 8, 2, 64, 32), "float32")
    before = FD.flash_decode_attention.launches
    a = FD.flash_decode_attention(tq, tk, tv, pos=40)
    b = FD.flash_decode_attention_plain(tq, tk, tv, pos=40)
    assert torch.equal(a, b)
    assert FD.flash_decode_attention.launches == before


@pytest.mark.parametrize("case", ["q_rank", "q_seq", "kv_mismatch", "batch",
                                  "heads", "dtype_mix", "dtype_f16"])
def test_wrapper_refuses_bad_operands(case):
    q = torch.zeros(2, 1, 8, 16)
    k = torch.zeros(2, 2, 32, 16)
    v = torch.zeros(2, 2, 32, 16)
    err = ValueError
    if case == "q_rank":
        q = torch.zeros(2, 8, 16)
    elif case == "q_seq":
        q = torch.zeros(2, 2, 8, 16)
    elif case == "kv_mismatch":
        v = torch.zeros(2, 2, 16, 16)
    elif case == "batch":
        q = torch.zeros(3, 1, 8, 16)
    elif case == "heads":
        k = v = torch.zeros(2, 3, 32, 16)
        q = torch.zeros(2, 1, 8, 16)
    elif case == "dtype_mix":
        k = k.bfloat16()
        err = TypeError
    elif case == "dtype_f16":
        q, k, v = q.half(), k.half(), v.half()
        err = TypeError
    with pytest.raises(err):
        FD.flash_decode_attention(q, k, v, pos=4)


@pytest.mark.parametrize("case", ["noncontig", "head_dim", "shared_mem"])
def test_kernel_layout_refusals(case):
    """What a CUDA launch would refuse, checked on host tensors."""
    q = torch.zeros(1, 1, 16, 128, dtype=torch.bfloat16)
    k = torch.zeros(1, 2, 64, 128, dtype=torch.bfloat16)
    v = torch.zeros(1, 2, 64, 128, dtype=torch.bfloat16)
    FD._check_launchable(q, k, v)                    # the served shape is fine
    if case == "noncontig":
        k = torch.zeros(1, 64, 2, 128, dtype=torch.bfloat16).transpose(1, 2)
    elif case == "head_dim":
        q = torch.zeros(1, 1, 16, 12, dtype=torch.bfloat16)
        k = v = torch.zeros(1, 2, 64, 12, dtype=torch.bfloat16)
    elif case == "shared_mem":
        # 512 heads of 256 f32 values outgrew the first kernel's shared
        # memory; the kernel's shared memory no longer grows with G, and a
        # row of 64 16-byte loads exceeds a warp's 32 lanes
        q = torch.zeros(1, 1, 512, 256)
        k = v = torch.zeros(1, 1, 64, 256)
    with pytest.raises(ValueError):
        FD._check_launchable(q, k, v)


def test_pos_buffer_folds_and_refuses():
    buf, per_row = FD._pos_buffer(torch.tensor([7]), 4, torch.device("cpu"))
    assert per_row == 0 and buf.dtype == torch.int32 and buf.tolist() == [7]
    buf, per_row = FD._pos_buffer(torch.tensor([1, 2, 3]), 3,
                                  torch.device("cpu"))
    assert per_row == 1
    buf, per_row = FD._pos_buffer(5, 2, torch.device("cpu"))
    assert per_row == 0 and buf.tolist() == [5]
    with pytest.raises(ValueError):
        FD._pos_buffer(torch.tensor([1, 2]), 3, torch.device("cpu"))


@pytest.mark.parametrize("B,KH,S", [(1, 2, 2048), (1, 2, 64), (4, 8, 100),
                                    (1, 1, 1), (128, 2, 32768), (2, 2, 48)])
def test_split_plan_covers_the_cache(B, KH, S):
    n = FD.split_plan(B, KH, S)
    assert n >= 1
    assert (n - 1) * FD.ALIGN_K < S              # no split always empty
    assert n <= FD.MAX_SPLIT                     # one cluster a row
    assert B * KH * n <= max(FD.TARGET_BLOCKS, B * KH)
    assert FD.split_plan(B, KH, S, row_groups=2) <= n


def test_split_plan_fills_the_card_at_the_served_shape():
    # qwen2.5-3b (B 1, 2 KV heads of 8 query heads, two row groups of 4):
    # a full cluster of 16 a row group; zamba2-7b (32 KV heads, G 1): 8 a
    # head, about two blocks an SM of 132
    assert FD.row_tile(8) == (4, 2) and FD.row_tile(1) == (1, 1)
    assert FD.split_plan(1, 2, 2048, row_groups=2) == 16
    assert FD.split_plan(1, 32, 2048) == 8
    for KH, rg in ((2, 2), (32, 1)):
        n = FD.split_plan(1, KH, 2048, row_groups=rg)
        # at the served pos every block has keys: 1025 live keys
        assert all(k1 > k0 for k0, k1 in
                   (FD.slice_bounds(1025, i, n) for i in range(n)))


@pytest.mark.parametrize("G,want", [(1, (1, 1)), (2, (2, 1)), (3, (4, 1)),
                                    (8, (4, 2)), (12, (4, 3)), (32, (4, 8))])
def test_row_tile(G, want):
    assert FD.MAX_ROW_TILE == 4
    assert FD.row_tile(G) == want


def _plans():
    """Every n_split the plan gives for some grid, and a few beyond."""
    return sorted({FD.split_plan(B, KH, S) for B in (1, 2, 4)
                   for KH in (1, 2, 8, 32) for S in (1, 17, 64, 100, 2048)}
                  | {1, 3, 7, FD.MAX_SPLIT})


_PLANS = _plans()


@hypothesis.given(st.integers(1, 4096), st.integers(0, len(_PLANS) - 1),
                  st.integers(0, 4101))
@hypothesis.settings(max_examples=200, deadline=None)
def test_slice_bounds_cover_the_live_prefix_once(S, plan, draw):
    """The device's slice arithmetic (mirrored): for valid in [0, S + 5]
    clamped to S and every planned n_split, each live key lies in exactly
    one split, no slice reaches past valid, and the shares differ by at
    most one ``ALIGN_K``-key unit."""
    n_split = _PLANS[plan]
    valid = min(draw % (S + 6), S)
    covered = np.zeros(valid, dtype=np.int64)
    units = []
    for i in range(n_split):
        k0, k1 = FD.slice_bounds(valid, i, n_split)
        assert k0 % FD.ALIGN_K == 0 and k0 >= 0
        if k1 > k0:
            assert k1 <= valid
            covered[k0:k1] += 1
        units.append(max(0, -(-(k1 - k0) // FD.ALIGN_K)))
    assert (covered == 1).all()
    assert max(units) - min(units) <= 1


def test_bound_bytes_counts_the_valid_prefix():
    q = torch.zeros(1, 1, 16, 128, dtype=torch.bfloat16)
    k = torch.zeros(1, 2, 2048, 128, dtype=torch.bfloat16)
    assert FD.bound_bytes(q, k, 1024) == 2 * 2 * 1024 * 128 * 2 \
        + 2 * 16 * 128 * 2
    assert FD.bound_bytes(q, k, 5000) == FD.bound_bytes(q, k, 2048)
