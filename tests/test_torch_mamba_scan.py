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
    here on CPU tensors), its output pass's grid, and the bound at the
    served shapes."""
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
    # meta tensors (a dry run's shapes) give the outputs' shapes and
    # launch nothing; a mix of devices is refused, not handed to the plain
    # version
    meta = [t.to("meta") for t in (dt, Bc, Cc, x, A)]
    y, h = MS.mamba1_scan(*meta)
    assert y.is_meta and y.shape == x.shape and h.shape == (1, 64, 16)
    with pytest.raises(ValueError, match="CUDA"):
        MS.mamba1_scan(dt, Bc, Cc, x.to("meta"), A)
    # falcon-mamba-7b: Di 8192, N 16 -> 64 channels a block, 128 blocks,
    # in each of 16 chunks at the served prompt
    assert MS.plan(1, 1024, 8192, 16)[-1][1] == (128, 16, 1)
    assert MS.plan(2, 100, 96, 8)[-1][1] == (2, 2, 2)
    for S, h0, nbytes in ((1, True, 1_622_080), (1024, False, 51_445_760)):
        xb = torch.empty(1, S, 8192, dtype=torch.bfloat16, device="meta")
        bb = torch.empty(1, S, 16, dtype=torch.bfloat16, device="meta")
        assert MS.bound_bytes(xb, bb, xb, h0) == nbytes
        assert MS.bound_flops(xb, bb) == 6 * S * 8192 * 16
        assert MS.bound_exps(xb, bb) == S * 8192 * 16


# ---------------------------------------------------------------------------
# the chunk-parallel kernel's launch plan and algebra
# ---------------------------------------------------------------------------

def test_plan_launches_grids_and_scratch():
    """The decode step and any S <= CHUNK run the output pass alone, from
    h0, with no scratch; longer calls run chunk states, the carry and the
    outputs, with an N-state and a sum of dt a (b, chunk, d) of scratch."""
    assert MS.CHUNK == 64 and MS.CHANNELS == 64
    # bf16, N 16: 8 threads a channel alone, 2 in three launches; tiles
    # of 32 steps of dt, x (and y) for 64 channels of 2 bytes and of B, C
    # (16 f32)
    state_smem = 32 * (2 * 64 * 2 + 2 * 16 * 4)
    scan_smem = 32 * (3 * 64 * 2 + 2 * 16 * 4)
    assert (state_smem, scan_smem) == (12_288, 16_384)
    assert MS.shared_bytes(16, 2, False) == state_smem
    assert MS.shared_bytes(16, 2, True) == scan_smem
    assert MS.shared_bytes(16, 4, True) == 28_672
    for S in (0, 1, 17, 64):
        assert MS.plan(1, S, 8192, 16) == [
            ("mamba1_chunk_scan_kernel", (128, 1, 1), 512, scan_smem)]
        assert MS.scratch_floats(1, S, 8192, 16) == 0
    for S, nc, scratch_bytes in ((65, 2, 1_114_112), (1024, 16, 8_912_896),
                                 (1048, 17, 9_469_952),
                                 (2048, 32, 17_825_792)):
        assert MS.n_chunks(S) == nc
        assert MS.plan(1, S, 8192, 16) == [
            ("mamba1_chunk_state_kernel", (128, nc - 1, 1), 128,
             state_smem),
            ("mamba1_carry_kernel", (512, 1), 256, 0),
            ("mamba1_chunk_scan_kernel", (128, nc, 1), 128, scan_smem)]
        assert 4 * MS.scratch_floats(1, S, 8192, 16) == scratch_bytes
    # a ragged channel block and batch rows, f32, N 8: one thread a
    # channel in three launches, four alone; N 4, one thread a channel
    assert MS.plan(2, 100, 96, 8, 4) == [
        ("mamba1_chunk_state_kernel", (2, 1, 2), 64, 32 * (512 + 64)),
        ("mamba1_carry_kernel", (3, 2), 256, 0),
        ("mamba1_chunk_scan_kernel", (2, 2, 2), 64, 32 * (768 + 64))]
    assert MS.plan(1, 1, 96, 8, 4)[0][2] == 256
    assert MS.plan(1, 100, 96, 4, 4)[0][2] == 64
    # more chunks than a grid dimension takes are refused before a launch
    S = 64 * 2 ** 16 + 1
    seq = [torch.empty(1, S, w, device="meta") for w in (8, 4, 4, 8)]
    with pytest.raises(ValueError, match="65536"):
        MS._check_launchable(*seq, torch.zeros(8, 4), None)


def _three_pass(dt, Bc, Cc, x, A, h0=None, L=MS.CHUNK):
    """The CUDA kernel's algebra in plain torch f32: chunks of L steps from
    t = 0; pass 1 scans every chunk but the last from zeros (its local end
    state and its sum of dt), pass 2 carries h_start[c + 1] =
    exp(A * sum dt_c) * h_start[c] + local_c from h0, pass 3 rescans each
    chunk from h_start[c] for y, and the final state is the carry formula
    applied to the last chunk."""
    B, S, Di = x.shape
    N = Bc.shape[-1]
    dtf, bf, cf, xf = (t.float() for t in (dt, Bc, Cc, x))
    Af = A.float()
    zero = torch.zeros(B, Di, N)
    nc = max(1, -(-S // L))

    def scan(c, h):
        ys, sdt = [], torch.zeros(B, Di)
        for t in range(c * L, min(S, (c + 1) * L)):
            d = dtf[:, t]
            h = torch.exp(d[..., None] * Af) * h \
                + (d * xf[:, t])[..., None] * bf[:, t, None, :]
            sdt = sdt + d
            ys.append((h * cf[:, t, None, :]).sum(-1))
        return ys, h, sdt

    def carry(sdt, h, local):
        return torch.exp(sdt[..., None] * Af) * h + local

    starts = [zero if h0 is None else h0.float()]
    for c in range(nc - 1):                                 # passes 1, 2
        _, local, sdt = scan(c, zero)
        starts.append(carry(sdt, starts[-1], local))
    ys = [y for c in range(nc) for y in scan(c, starts[c])[0]]   # pass 3
    _, local, sdt = scan(nc - 1, zero)
    y = torch.stack(ys, 1) if ys else xf.new_zeros((B, 0, Di))
    return y.to(x.dtype), carry(sdt, starts[-1], local), starts


@pytest.mark.parametrize("B,S,Di,N,chunk,block_d", GRID)
@pytest.mark.parametrize("L", [16, MS.CHUNK])
@pytest.mark.parametrize("with_h0", [False, True])
def test_three_pass_algebra_matches_jax_kernel_and_oracle(
        B, S, Di, N, chunk, block_d, L, with_h0):
    """The chunked algebra (S 70 and 100 are not multiples of either L)
    against the JAX kernel in interpret mode and ``ref.mamba1_scan_ref``
    at the reference tolerance, and the sequential plain version."""
    arrays = _inputs(B, S, Di, N, seed=8)
    h0 = np.random.default_rng(9).standard_normal((B, Di, N)).astype(
        np.float32) if with_h0 else None
    jargs, targs = _both(arrays, "float32")
    jh0 = None if h0 is None else jnp.asarray(h0)
    th0 = None if h0 is None else torch.from_numpy(h0)
    y, h, _ = _three_pass(*targs, h0=th0, L=L)
    for want_y, want_h in (
            jax_mamba1_scan(*jargs, h0=jh0, chunk=chunk, block_d=block_d),
            ref.mamba1_scan_ref(*jargs, h0=jh0)):
        _close(y, want_y, _tol("float32"))
        _close(h, want_h, _tol("float32"))
    yp, hp = MS.mamba1_scan_plain(*targs, h0=th0)
    _close(y, yp.numpy(), 1e-5)
    _close(h, hp.numpy(), 1e-5)


@pytest.mark.parametrize("live", [1, 25, 48, 63, 64, 65, 100])
@pytest.mark.parametrize("with_h0", [False, True])
def test_three_pass_masked_state_is_bit_equal_at_any_live_length(live,
                                                                 with_h0):
    """dt = 0 past the live length (chunk-aligned or not, in the first
    chunk or a later one) leaves the final state bit for bit as the live
    scan's: chunk boundaries do not move with S, and a fully masked chunk
    carries exactly (decay 1, local state 0).  The chunk starts the two
    calls share are bit-equal too (S 1024 against S 2048 in the kernel)."""
    S, L = 130, 16
    dt, Bc, Cc, x, A = _inputs(2, S, 24, 8, seed=10)
    dt[:, live:] = 0
    _, targs = _both((dt, Bc, Cc, x, A), "float32")
    h0 = torch.from_numpy(np.random.default_rng(11).standard_normal(
        (2, 24, 8)).astype(np.float32)) if with_h0 else None
    _, h_pad, starts_pad = _three_pass(*targs, h0=h0, L=L)
    _, h_live, starts_live = _three_pass(*(a[:, :live] for a in targs[:4]),
                                         targs[4], h0=h0, L=L)
    assert torch.equal(h_pad, h_live)
    for a, b in zip(starts_pad, starts_live):
        assert torch.equal(a, b)
