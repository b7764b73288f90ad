"""Port of ssd_scan: the plain PyTorch version (what the wrapper runs on a
CPU tensor) against the JAX package's Pallas kernel (interpret mode on the
CPU) and its sequential oracle ``repro.models.ssm.mamba2_scan`` over the
reference's grid, state continuation, a single step from a non-zero
state, a masked dt, and the wrapper's refusals and launch plan.  The CUDA
kernel itself is held against the plain version in tests/test_torch_cuda.py
and chip_smoke.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd_scan import ssd_scan as jax_ssd_scan  # noqa: E402
from repro.models.ssm import mamba2_scan as jax_mamba2_scan  # noqa: E402
from repro_torch.kernels import ssd_scan as SD  # noqa: E402
from repro_torch.models import ssm as SSM  # noqa: E402

# tests/test_ssd_kernel.py's grid: (B, S, H, P, N, chunk)
GRID = [(1, 32, 2, 16, 8, 8), (2, 64, 4, 32, 16, 16),
        (1, 50, 3, 8, 4, 16), (2, 16, 1, 64, 32, 16)]


def _tol(dtype):
    """tests/test_ssd_kernel.py's tolerance."""
    return 5e-2 if dtype == "bfloat16" else 1e-4


def _inputs(B, S, H, P, N, seed=0):
    """dt = softplus(normal), B, C, x normal, A = -exp(0.3 normal): the
    reference test's distributions, drawn with numpy."""
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    Bc = rng.standard_normal((B, S, N)).astype(np.float32)
    Cc = rng.standard_normal((B, S, N)).astype(np.float32)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    A = (-np.exp(rng.standard_normal((H,)) * 0.3)).astype(np.float32)
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


@pytest.mark.parametrize("B,S,H,P,N,chunk", GRID)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_kernel_and_oracle(B, S, H, P, N, chunk, dtype):
    jargs, targs = _both(_inputs(B, S, H, P, N), dtype)
    y, h = SD.ssd_scan(*targs)
    assert y.dtype == targs[3].dtype and h.dtype == torch.float32
    assert tuple(y.shape) == (B, S, H, P) and tuple(h.shape) == (B, H, P, N)
    for want_y, want_h in (jax_ssd_scan(*jargs, chunk=chunk),
                           jax_mamba2_scan(*jargs, chunk=chunk)):
        _close(y, want_y, _tol(dtype))
        _close(h, want_h, _tol(dtype))


def test_state_continuation():
    """Scanning [0:32] equals scanning [0:16] then [16:32] with carried h
    (tests/test_ssd_kernel.py's case), and matches the JAX kernel's
    split."""
    jargs, targs = _both(_inputs(1, 32, 2, 8, 4, seed=1), "float32")
    y_full, h_full = SD.ssd_scan(*targs)
    h, jh, outs = None, None, []
    for sl in (slice(0, 16), slice(16, 32)):
        y, h = SD.ssd_scan(*(a[:, sl] for a in targs[:4]), targs[4], h0=h)
        jy, jh = jax_ssd_scan(*(a[:, sl] for a in jargs[:4]), jargs[4],
                              h0=jh, chunk=8)
        _close(y, jy, 1e-5)
        outs.append(y)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), y_full.numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(h.numpy(), h_full.numpy(), atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_single_step_from_nonzero_state(dtype):
    """S = 1 from a non-zero h0: the decode step's scan."""
    arrays = _inputs(2, 1, 4, 16, 8, seed=2)
    h0 = np.random.default_rng(3).standard_normal((2, 4, 16, 8)).astype(
        np.float32)
    jargs, targs = _both(arrays, dtype)
    y, h = SD.ssd_scan(*targs, h0=torch.from_numpy(h0))
    for want_y, want_h in (jax_ssd_scan(*jargs, h0=jnp.asarray(h0)),
                           jax_mamba2_scan(*jargs, h0=jnp.asarray(h0))):
        _close(y, want_y, _tol(dtype))
        _close(h, want_h, _tol(dtype))


def test_masked_dt_freezes_the_state():
    """The recompute arm's scan: dt = 0 past the live length leaves h at
    the live prefix's state, bit for bit, and matches the JAX kernel."""
    dt, Bc, Cc, x, A = _inputs(1, 40, 3, 8, 4, seed=4)
    dt[:, 25:] = 0
    jargs, targs = _both((dt, Bc, Cc, x, A), "float32")
    y, h = SD.ssd_scan(*targs)
    _, h_live = SD.ssd_scan(*(a[:, :25] for a in targs[:4]), targs[4])
    assert torch.equal(h, h_live)
    yk, hk = jax_ssd_scan(*jargs, chunk=16)
    _close(y, yk, 1e-4)
    _close(h, hk, 1e-4)


def test_model_scan_routes():
    """``models.ssm.mamba2_scan``: the kernel route on a CPU tensor is the
    plain version (y cast to f32, as the reference's kernel route casts
    it) and counts no launch; ``plain``/``jnp`` name it; an unknown impl
    raises."""
    _, targs = _both(_inputs(1, 8, 2, 8, 4, seed=5), "bfloat16")
    before = SD.ssd_scan.launches
    y_want, h_want = SD.ssd_scan_plain(*targs)
    for impl in ("kernel", "pallas", "plain", "jnp"):
        y, h = SSM.mamba2_scan(*targs, impl=impl)
        assert y.dtype == torch.float32
        assert torch.equal(y, y_want.float()) and torch.equal(h, h_want)
    assert SD.ssd_scan.launches == before
    with pytest.raises(ValueError, match="impl"):
        SSM.mamba2_scan(*targs, impl="nope")


@pytest.mark.parametrize("case", ["x_rank", "dt_shape", "bc_shape", "A_shape",
                                  "h0_shape", "dtype_mix", "dtype_f16"])
def test_wrapper_refuses_bad_operands(case):
    dt, x = torch.zeros(2, 8, 4), torch.zeros(2, 8, 4, 16)
    Bc, Cc = torch.zeros(2, 8, 8), torch.zeros(2, 8, 8)
    A, h0 = torch.zeros(4), None
    err = ValueError
    if case == "x_rank":
        x = torch.zeros(2, 8, 64)
    elif case == "dt_shape":
        dt = torch.zeros(2, 8, 3)
    elif case == "bc_shape":
        Cc = torch.zeros(2, 8, 4)
    elif case == "A_shape":
        A = torch.zeros(4, 1)
    elif case == "h0_shape":
        h0 = torch.zeros(2, 4, 8, 16)
    elif case == "dtype_mix":
        Bc = Bc.bfloat16()
        err = TypeError
    elif case == "dtype_f16":
        Bc, Cc, x = Bc.half(), Cc.half(), x.half()
        err = TypeError
    with pytest.raises(err):
        SD.ssd_scan(dt, Bc, Cc, x, A, h0=h0)


def test_kernel_launch_refusals_and_plan():
    """What the kernel needs beyond the contract (checked before a launch,
    here on CPU tensors), its grid and shared memory, and the bound at the
    served shapes."""
    H, P, N = 4, 16, 8
    dt = torch.zeros(1, 4, H)
    xbc = torch.zeros(1, 4, H * P + 2 * N)        # the model's column views
    x = xbc[..., :H * P].reshape(1, 4, H, P)
    Bc, Cc = xbc[..., H * P:H * P + N], xbc[..., H * P + N:]
    A = torch.zeros(H)
    SD._check_launchable(dt, Bc, Cc, x, A, None)
    with pytest.raises(ValueError, match="multiples of 4"):
        SD._check_launchable(dt, torch.zeros(1, 4, 6), torch.zeros(1, 4, 6),
                             x, A, None)
    with pytest.raises(ValueError, match="shared memory"):
        SD._check_launchable(dt, torch.zeros(1, 4, 256),
                             torch.zeros(1, 4, 256),
                             torch.zeros(1, 4, H, 256), A, None)
    with pytest.raises(ValueError, match="last dimension"):
        SD._check_launchable(dt, Bc, Cc,
                             torch.zeros(1, 4, P, H).transpose(2, 3), A, None)
    with pytest.raises(TypeError, match="float32"):
        SD._check_launchable(dt, Bc, Cc, x, A, torch.zeros(1, H, P, N,
                                                           dtype=torch.half))
    # meta tensors (a dry run's shapes) give the outputs' shapes and
    # launch nothing; a mix of devices is refused
    meta = [t.to("meta") for t in (dt, Bc, Cc, x, A)]
    y, h = SD.ssd_scan(*meta)
    assert y.is_meta and y.shape == x.shape and h.shape == (1, H, P, N)
    with pytest.raises(ValueError, match="CUDA"):
        SD.ssd_scan(dt, Bc, Cc, x.to("meta"), A)
    # zamba2-7b (H 112 heads of P 64, N 64) at batch 1: a decode step is
    # 112 x 8 blocks of 8 rows; any longer call three chunk-parallel
    # launches, one chunk a head at 64 steps and 16 at 1024, whose bf16
    # blocks take 19 and 46 KB; a sequential block would take 83 KB there
    assert SD.plan(1, 1, 112, 64, 64) == [("ssd_step_kernel", (112, 8), 256,
                                           0)]
    assert SD.plan(1, 64, 112, 64, 64) == [
        ("ssd_chunk_state_kernel", (112, 1), 128, 19_456),
        ("ssd_state_pass_kernel", (112, 4), 256, 0),
        ("ssd_chunk_scan_kernel", (112, 1), 128, 47_104)]
    assert SD.shared_bytes(64, 64) == 83_200
    assert SD.plan(1, 1024, 112, 64, 64) == [
        ("ssd_chunk_state_kernel", (112, 16), 128, 19_456),
        ("ssd_state_pass_kernel", (112, 4), 256, 0),
        ("ssd_chunk_scan_kernel", (112, 16), 128, 47_104)]
    assert [k for k, *_ in SD.plan(1, 65, 112, 64, 64)] == [
        "ssd_chunk_state_kernel", "ssd_state_pass_kernel",
        "ssd_chunk_scan_kernel"]
    # a width without chunk kernels stays sequential at any length
    assert SD.plan(1, 1024, 4, 16, 8, 4) == [("ssd_scan_kernel", (4,), 256,
                                              SD.shared_bytes(16, 8))]
    for S, h0, nbytes in ((1, True, 3_699_840), (1024, False, 31_916_480)):
        dtm = torch.empty(1, S, 112, device="meta")
        xm = torch.empty(1, S, 112, 64, dtype=torch.bfloat16, device="meta")
        bm = torch.empty(1, S, 64, dtype=torch.bfloat16, device="meta")
        assert SD.bound_bytes(dtm, bm, xm, h0) == nbytes
        L = min(SD.CHUNK, S)
        assert SD.bound_flops(xm, bm) == 112 * (2 * S * L * 128
                                                + 4 * S * 64 * 64)


@pytest.mark.parametrize("B,S,H,P,N", [(1, 1, 112, 64, 64),
                                       (1, 64, 112, 64, 64),
                                       (1, 65, 112, 64, 64),
                                       (1, 1024, 112, 64, 64),
                                       (2, 2048, 112, 64, 64),
                                       (1, 300, 4, 32, 16),
                                       (2, 50, 3, 8, 4)])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_plan_fits_shared_memory_and_sizes_scratch(B, S, H, P, N, itemsize):
    """Every launch of the plan fits a block's 227 KB, and the scratch is
    what the chunk kernels address: n_chunks P x N states and n_chunks
    decays for every (b, h)."""
    launches = SD.plan(B, S, H, P, N, itemsize)
    assert all(smem <= 227 * 1024 for *_, smem in launches)
    nc = -(-S // SD.CHUNK)
    if SD.path(S, P, N) == "chunked":
        assert launches[0][1] == launches[2][1] == (B * H, nc)
        assert SD.scratch_floats(B, S, H, P, N) == B * H * nc * (P * N + 1)
    else:
        assert SD.scratch_floats(B, S, H, P, N) == 0


def _three_pass(dt, Bc, Cc, x, A, h0=None, chunk=SD.CHUNK):
    """The chunk-parallel kernels' algorithm in plain f32, chunk by chunk
    as their grids run it: (1) each chunk's cum, own state contribution
    x^T (B * exp(cum_L - cum_s) dt_s) and decay exp(cum_L); (2) the state
    passed over the chunks in order, each chunk's starting state kept;
    (3) each chunk's y = (C B^T * exp(cum_t - cum_s) dt_s, s <= t) x +
    exp(cum_t) C h_start^T.  A ragged last chunk is zero-padded, as the
    kernels zero-fill its rows."""
    B, S, H = dt.shape
    P, N = x.shape[-1], Bc.shape[-1]
    nc = -(-S // chunk)
    pad = nc * chunk - S
    dtf = torch.nn.functional.pad(dt.float(), (0, 0, 0, pad))
    bf = torch.nn.functional.pad(Bc.float(), (0, 0, 0, pad))
    cf = torch.nn.functional.pad(Cc.float(), (0, 0, 0, pad))
    xf = torch.nn.functional.pad(x.float(), (0, 0, 0, 0, 0, pad))
    causal = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool))
    states, decays, cums = [], [], []
    for c in range(nc):                                  # pass 1
        sl = slice(c * chunk, (c + 1) * chunk)
        cum = torch.cumsum(dtf[:, sl] * A.float(), dim=1)       # (B, L, H)
        w = torch.exp(cum[:, -1:] - cum) * dtf[:, sl]
        states.append(torch.einsum("blhp,bln,blh->bhpn", xf[:, sl], bf[:, sl],
                                   w))
        decays.append(torch.exp(cum[:, -1]))                    # (B, H)
        cums.append(cum)
    h = torch.zeros((B, H, P, N)) if h0 is None else h0.float()
    starts = []
    for c in range(nc):                                  # pass 2
        starts.append(h)
        h = decays[c][:, :, None, None] * h + states[c]
    ys = []
    for c in range(nc):                                  # pass 3
        sl = slice(c * chunk, (c + 1) * chunk)
        cum = cums[c]
        seg = (cum[:, :, None, :] - cum[:, None, :, :]).masked_fill(
            ~causal[None, :, :, None], float("-inf"))           # (B, t, s, H)
        m = torch.einsum("btn,bsn->bts", cf[:, sl], bf[:, sl])[..., None] \
            * torch.exp(seg) * dtf[:, None, sl]
        ys.append(torch.einsum("btsh,bshp->bthp", m, xf[:, sl])
                  + torch.exp(cum)[..., None]
                  * torch.einsum("btn,bhpn->bthp", cf[:, sl], starts[c]))
    return torch.cat(ys, 1)[:, :S], h


def _mirror_case(B, S, H, P, N, chunk, with_h0, tol):
    jargs, targs = _both(_inputs(B, S, H, P, N, seed=8), "float32")
    h0 = np.random.default_rng(9).standard_normal((B, H, P, N)).astype(
        np.float32) if with_h0 else None
    th0 = None if h0 is None else torch.from_numpy(h0)
    y, h = _three_pass(*targs, h0=th0, chunk=chunk)
    y_plain, h_plain = SD.ssd_scan_plain(*targs, h0=th0)
    jy, jh = jax_ssd_scan(*jargs, h0=None if h0 is None else jnp.asarray(h0),
                          chunk=chunk)
    for got, want in ((y, y_plain), (h, h_plain), (y, jy), (h, jh)):
        _close(got, want, tol)


@pytest.mark.parametrize("B,S,H,P,N,chunk", GRID)
@pytest.mark.parametrize("with_h0", [False, True])
def test_three_pass_mirror_matches_plain_and_jax(B, S, H, P, N, chunk,
                                                 with_h0):
    """The chunk-parallel decomposition is exact: in f32, at the reference
    grid's chunks (several a sequence), it agrees with the sequential
    plain scan and the JAX kernel at 1e-5."""
    _mirror_case(B, S, H, P, N, chunk, with_h0, 1e-5)


@pytest.mark.parametrize("with_h0", [False, True])
def test_three_pass_mirror_at_the_kernels_chunk(with_h0):
    """At the kernels' chunk of 64, f32 rounding of the chunked form
    (exp of differences of a cumsum over 64 steps) reaches ~2e-5 against
    the sequential scan: held at the reference's f32 tolerance, 1e-4."""
    _mirror_case(1, 200, 3, 32, 16, SD.CHUNK, with_h0, _tol("float32"))


def test_three_pass_mirror_freezes_state_past_aligned_live_length():
    """dt = 0 past a chunk-aligned live length: the padded chunks add exact
    zeros and decay by exp(0) = 1, so h equals the live scan's bit for
    bit (the masked recompute's property)."""
    dt, Bc, Cc, x, A = _inputs(1, 96, 3, 16, 8, seed=10)
    dt[:, 48:] = 0
    _, targs = _both((dt, Bc, Cc, x, A), "float32")
    _, h_pad = _three_pass(*targs, chunk=16)
    _, h_live = _three_pass(*(a[:, :48] for a in targs[:4]), targs[4],
                            chunk=16)
    assert torch.equal(h_pad, h_live)
