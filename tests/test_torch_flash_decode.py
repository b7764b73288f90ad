"""Port of flash_decode_attention: the plain PyTorch version against the
JAX package's Pallas kernel (interpret mode on the CPU), the wrapper's
refusals, and the split plan.  The CUDA kernel itself is held against the
plain version in tests/test_torch_cuda.py and chip_smoke.py."""
import numpy as np
import pytest

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
    n, chunk = FD.split_plan(B, KH, S)
    assert n >= 1 and chunk % FD.TILE_K == 0
    assert n * chunk >= S > (n - 1) * chunk          # every split has keys
    assert chunk >= min(FD.MIN_SPLIT_KEYS, S) or n == 1
    assert B * KH * (n - 1) < FD.TARGET_BLOCKS       # no more than needed


def test_split_plan_fills_the_card_at_the_served_shape():
    n, chunk = FD.split_plan(1, 2, 2048)             # qwen2.5-3b, max_seq 2048
    assert (n, chunk) == (32, 64)


def test_bound_bytes_counts_the_valid_prefix():
    q = torch.zeros(1, 1, 16, 128, dtype=torch.bfloat16)
    k = torch.zeros(1, 2, 2048, 128, dtype=torch.bfloat16)
    assert FD.bound_bytes(q, k, 1024) == 2 * 2 * 1024 * 128 * 2 \
        + 2 * 16 * 128 * 2
    assert FD.bound_bytes(q, k, 5000) == FD.bound_bytes(q, k, 2048)
