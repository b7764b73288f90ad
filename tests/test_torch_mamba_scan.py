"""Port of mamba1_scan: the plain PyTorch version (what the wrapper runs on
a CPU tensor) against the JAX package's Pallas kernel (interpret mode on
the CPU) and its sequential oracle ``ref.mamba1_scan_ref`` over the
reference's grid, state continuation, a single step from a non-zero
state, a masked dt, and the wrapper's refusals and launch plan.  The CUDA
kernel itself is held against the plain version in tests/test_torch_cuda.py
and chip_smoke.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref  # noqa: E402
from repro.kernels.mamba_scan import mamba1_scan as jax_mamba1_scan  # noqa: E402
from repro_torch.kernels import mamba_scan as MS  # noqa: E402
from repro_torch.models import ssm as SSM  # noqa: E402

# tests/test_kernels.py's grid: (B, S, Di, N, chunk, block_d)
GRID = [(1, 16, 32, 8, 8, 16), (2, 32, 64, 16, 16, 32),
        (1, 70, 48, 8, 16, 32), (2, 100, 96, 16, 32, 64)]


def _tol(dtype):
    """tests/test_kernels.py's ``_tol``."""
    return 2e-2 if dtype == "bfloat16" else 1e-4


def _inputs(B, S, Di, N, seed=2):
    """dt = softplus(normal), B, C, x normal, A = -exp(0.2 normal): the
    reference test's distributions, drawn with numpy."""
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, Di)))).astype(np.float32)
    Bc = rng.standard_normal((B, S, N)).astype(np.float32)
    Cc = rng.standard_normal((B, S, N)).astype(np.float32)
    x = rng.standard_normal((B, S, Di)).astype(np.float32)
    A = (-np.exp(rng.standard_normal((Di, N)) * 0.2)).astype(np.float32)
    return dt, Bc, Cc, x, A


def _both(arrays, dtype):
    """dt, Bc, Cc, x in ``dtype`` and A in f32, in both frameworks (bf16
    rounds identically)."""
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    *seq, A = arrays
    return ([jnp.asarray(a, jd) for a in seq] + [jnp.asarray(A)],
            [torch.from_numpy(a).to(td) for a in seq] + [torch.from_numpy(A)])


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("B,S,Di,N,chunk,block_d", GRID)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_kernel_and_oracle(B, S, Di, N, chunk, block_d,
                                             dtype):
    jargs, targs = _both(_inputs(B, S, Di, N), dtype)
    y, h = MS.mamba1_scan(*targs)
    assert y.dtype == targs[3].dtype and h.dtype == torch.float32
    assert tuple(y.shape) == (B, S, Di) and tuple(h.shape) == (B, Di, N)
    yk, hk = jax_mamba1_scan(*jargs, chunk=chunk, block_d=block_d)
    ye, he = ref.mamba1_scan_ref(*jargs)
    for want_y, want_h in ((yk, hk), (ye, he)):
        _close(y, want_y, _tol(dtype))
        _close(h, want_h, _tol(dtype))


def test_state_continuation():
    """Scanning [0:S] equals scanning [0:S/2] then [S/2:S] with carried h
    (tests/test_kernels.py's case), and matches the JAX kernel's split."""
    jargs, targs = _both(_inputs(1, 32, 32, 8, seed=3), "float32")
    y_full, h_full = MS.mamba1_scan(*targs)
    h, jh, outs = None, None, []
    for sl in (slice(0, 16), slice(16, 32)):
        y, h = MS.mamba1_scan(*(a[:, sl] for a in targs[:4]), targs[4],
                              h0=h)
        jy, jh = jax_mamba1_scan(*(a[:, sl] for a in jargs[:4]), jargs[4],
                                 h0=jh, chunk=8, block_d=16)
        _close(y, jy, 1e-5)
        outs.append(y)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), y_full.numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(h.numpy(), h_full.numpy(), atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_single_step_from_nonzero_state(dtype):
    """S = 1 from a non-zero h0: the decode step's scan."""
    arrays = _inputs(2, 1, 64, 16, seed=4)
    h0 = np.random.default_rng(5).standard_normal((2, 64, 16)).astype(
        np.float32)
    jargs, targs = _both(arrays, dtype)
    y, h = MS.mamba1_scan(*targs, h0=torch.from_numpy(h0))
    for want_y, want_h in (jax_mamba1_scan(*jargs, h0=jnp.asarray(h0)),
                           ref.mamba1_scan_ref(*jargs, h0=jnp.asarray(h0))):
        _close(y, want_y, _tol(dtype))
        _close(h, want_h, _tol(dtype))


def test_masked_dt_freezes_the_state():
    """The recompute arm's scan: dt = 0 past the live length leaves h at
    the live prefix's state, bit for bit, and matches the JAX kernel."""
    dt, Bc, Cc, x, A = _inputs(1, 40, 32, 8, seed=6)
    dt[:, 25:] = 0
    jargs, targs = _both((dt, Bc, Cc, x, A), "float32")
    y, h = MS.mamba1_scan(*targs)
    _, h_live = MS.mamba1_scan(*(a[:, :25] for a in targs[:4]), targs[4])
    assert torch.equal(h, h_live)
    yk, hk = jax_mamba1_scan(*jargs, chunk=16, block_d=16)
    _close(y, yk, 1e-4)
    _close(h, hk, 1e-4)


def test_model_scan_routes():
    """``models.ssm.mamba1_scan``: the kernel route on a CPU tensor is the
    plain version and counts no launch; ``plain``/``jnp`` name it; an
    unknown impl raises."""
    _, targs = _both(_inputs(1, 8, 16, 4, seed=7), "float32")
    before = MS.mamba1_scan.launches
    want = MS.mamba1_scan_plain(*targs)
    for impl in ("kernel", "pallas", "plain", "jnp"):
        got = SSM.mamba1_scan(*targs, impl=impl)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), impl
    assert MS.mamba1_scan.launches == before
    with pytest.raises(ValueError, match="impl"):
        SSM.mamba1_scan(*targs, impl="nope")


@pytest.mark.parametrize("case", ["x_rank", "dt_shape", "bc_shape", "A_shape",
                                  "h0_shape", "dtype_mix", "dtype_f16"])
def test_wrapper_refuses_bad_operands(case):
    dt, x = torch.zeros(2, 8, 32), torch.zeros(2, 8, 32)
    Bc, Cc = torch.zeros(2, 8, 16), torch.zeros(2, 8, 16)
    A, h0 = torch.zeros(32, 16), None
    err = ValueError
    if case == "x_rank":
        dt = x = torch.zeros(8, 32)
    elif case == "dt_shape":
        dt = torch.zeros(2, 8, 16)
    elif case == "bc_shape":
        Cc = torch.zeros(2, 8, 8)
    elif case == "A_shape":
        A = torch.zeros(16, 32)
    elif case == "h0_shape":
        h0 = torch.zeros(2, 16, 32)
    elif case == "dtype_mix":
        Bc = Bc.bfloat16()
        err = TypeError
    elif case == "dtype_f16":
        dt, Bc, Cc, x = dt.half(), Bc.half(), Cc.half(), x.half()
        err = TypeError
    with pytest.raises(err):
        MS.mamba1_scan(dt, Bc, Cc, x, A, h0=h0)


def test_kernel_launch_refusals_and_plan():
    """What the kernel needs beyond the contract (checked before a launch,
    here on CPU tensors), its grid, and the bound at the served shapes."""
    dt, x = torch.zeros(1, 4, 64), torch.zeros(1, 4, 64)
    dbc = torch.zeros(1, 4, 8 + 32)
    Bc, Cc = dbc[..., 8:24], dbc[..., 24:]       # the model's column views
    A = torch.zeros(64, 16)
    MS._check_launchable(dt, Bc, Cc, x, A, None)
    with pytest.raises(ValueError, match="d_state"):
        MS._check_launchable(dt, torch.zeros(1, 4, 12), torch.zeros(1, 4, 12),
                             x, torch.zeros(64, 12), None)
    with pytest.raises(ValueError, match="last dimension"):
        MS._check_launchable(dt, torch.zeros(1, 16, 4).transpose(1, 2), Cc,
                             x, A, None)
    with pytest.raises(TypeError, match="float32"):
        MS._check_launchable(dt, Bc, Cc, x, A.bfloat16(), None)
    with pytest.raises(ValueError, match="empty"):
        MS._check_launchable(torch.zeros(0, 4, 64), Bc[:0], Cc[:0],
                             torch.zeros(0, 4, 64), A, None)
    # a tensor on neither the CPU nor a CUDA device is refused, not
    # handed to the plain version
    meta = [t.to("meta") for t in (dt, Bc, Cc, x, A)]
    with pytest.raises(ValueError, match="CUDA"):
        MS.mamba1_scan(*meta)
    # falcon-mamba-7b: Di 8192, N 16 -> 16 channels a block, 512 blocks
    assert MS.grid_plan(1, 8192, 16) == (512, 1)
    assert MS.grid_plan(2, 100, 8) == (4, 2)
    for S, h0, nbytes in ((1, True, 1_622_080), (1024, False, 51_445_760)):
        xb = torch.empty(1, S, 8192, dtype=torch.bfloat16, device="meta")
        bb = torch.empty(1, S, 16, dtype=torch.bfloat16, device="meta")
        assert MS.bound_bytes(xb, bb, xb, h0) == nbytes
        assert MS.bound_flops(xb, bb) == 7 * S * 8192 * 16
