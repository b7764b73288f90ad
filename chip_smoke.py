"""End-to-end smoke of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails:

1. device    — a CUDA device is present; prints nvidia-smi's name and power
               limit line.
2. build     — builds the hand-written kernels from ``src/repro_torch/csrc``
               (one nvcc per source, all started together); prints each
               flash_decode_kernel instantiation's registers and spills.
3. kernel    — holds each kernel against its plain PyTorch version on the
               card.  flash_decode: the reference test grid, the full-width
               decode shapes (qwen2.5-3b's and zamba2-7b's D 112), per-row
               pos with a dead row, size-1 pos vector == scalar.
               flash_attention: the reference shape grid and mask cases in
               f32 and bf16, D 112, sequence-major views of heads-major K/V
               (strides, no copies), and the full-width prefill shapes of
               both models (1024 and 2048 tokens, causal, bf16) and their
               recompute-shaped call (q_offset 1024, 300 queries).
               mamba1_scan and ssd_scan: the reference grids in f32 and
               bf16 with and without h0, state continuation (across chunk
               boundaries at full width too), and the full-width decode
               step (S = 1), prompt (S = 1024; ssd_scan also 64 and 65,
               with and without h0: each of its paths; mamba1_scan also
               2048, in f32 and bf16) and the recompute arm's scan (S =
               2048, dt masked past 1024, and for mamba1_scan past 1048,
               whose state must equal the live scan's).  Times kernel,
               plain version and, where one exists, one PyTorch library call at
               the full-width shapes, beside the least time the card could
               take (the largest of bytes over its data-sheet memory rate,
               operations over its data-sheet rate for their type and, for
               mamba1_scan, exponentials over the special-function unit's
               rate), mamba1_scan's device time a launch by kernel, and
               flash_decode's device time a call at pos 64, 1024 and 2048
               (torch.profiler; one launch a call, no other device work)
               and its wrapper's host time a call.
4. slice     — for each of full-width qwen2.5-3b (36 layers),
               falcon-mamba-7b (64 mamba1 layers) and zamba2-7b (81 mamba2
               layers, 13 shared-attention applications), in bf16 with
               random weights from a seeded generator: serves the
               edge-cloud decode pipeline (prompt 1024, max_seq 2048) with
               every scan, the prefill and the recompute arm on the
               kernels, repartitions live through 1/2 -> 1/4 -> 1/2 -> 3/4
               of the depth under switch_b2, switch_a and pause_resume,
               and checks every kernel's launches per decode step (the
               profiled step must show flash_decode_kernel's launches with
               device time), per prefill forward and per recompute
               hand-off, the paper's downtime ordering, finite logits,
               and that an unswitched session fed the same tokens gives
               the same logits.  Each
               switch prints what could hide in its downtime
               (``switch_probe``: the hand-off recompute's host dispatch
               and device span, allocator counters, garbage collections,
               threads, pending builds, SM clock and throttle reasons);
               every full garbage collection of the run is logged.
5. handoff   — both hand-off arms on the card: a switch pinned to the
               transfer arm must leave the logits bit-equal to the
               unswitched session's; after a switch pinned to the recompute
               arm, the moved layers' state (KV, conv, SSM) is held against
               the state the decode steps wrote and the logits against the
               unswitched session's, and planted faults (the moved layers'
               state stale by 8 steps, and lost) are read the same way and
               must fail the limit (on the SSM state where there is one).
6. stateless — one 1024-token prompt served through the stateless
               edge-cloud pipeline (``StageRunner``), then repartitioned
               under switch_b2, switch_a and pause_resume with a request
               after each; checks each kernel's launches per request, the
               downtime ordering, and logits bit-equal to the first
               request's after every switch.  pause_resume reloads phase
               4's checkpoint of the whole model from ``$TMPDIR`` (6.2 GB
               for qwen2.5-3b, ~14.5 GB for falcon-mamba-7b, ~13.5 GB for
               zamba2-7b; its free space is checked first), deleted after
               the model's phases.
7. report    — prints the script's wall, the ``kernels`` JSON line, the
               card's nvidia-smi line, and as the last line
               ``{"ok": true, "device": {...}}``.

Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import os
import resource
import subprocess
import sys
import threading
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
FP32_ATOL = 1e-4
# bf16 outputs: 1% of the largest |plain| value of the comparison.  One
# bf16 rounding step is at most 2**-7 (0.78%) of a value, so this admits
# one rounding flip at the largest output and nothing coarser.
BF16_RTOL = 1e-2
# the library yardstick rounds in its own order; it is held only to show
# it computes the same function, not as the kernel under test
LIB_RTOL = 5e-2
# after a recompute hand-off, against the unswitched session: the logits
# (end to end, 5% of the largest logit) and the moved layers' state, each
# kind (KV, conv, SSM) to 5% of its largest |value| (the recompute's
# prefill-shaped matmuls round otherwise than the decode steps', by under
# 1% on the card)
LOGIT_RTOL = 5e-2
STATE_RTOL = 5e-2


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


def cuda_ms(fn, iters: int) -> float:
    """Mean device milliseconds of ``fn(i)`` over ``iters`` launches
    (CUDA events, after a warm-up)."""
    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_diff(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


# ---------------------------------------------------------------------------
# phase 3: the kernel against its plain version
# ---------------------------------------------------------------------------

# tests/test_flash_decode.py's grid (block_k has no counterpart here)
GRID = [(2, 8, 2, 64, 32, 40), (1, 4, 4, 100, 16, 100),
        (2, 16, 8, 128, 64, 1), (1, 2, 1, 48, 8, 17),
        (2, 8, 2, 256, 32, 200)]
FULL = dict(B=1, H=16, KH=2, S=2048, D=128)      # qwen2.5-3b decode shape
ZFULL = dict(B=1, H=32, KH=32, S=2048, D=112)    # zamba2-7b's shared attn
FULL_POS = (1, 17, 1024, 2048)
TIMED_POS = 1024                                 # the served context length
DEVICE_POS = (64, 1024, 2048)                    # device time a call read at
DECODE_KERNEL = "flash_decode_kernel"            # its name in the profiler


def phase_kernel(FD, gen) -> dict:
    errs = {"float32": 0.0, "bfloat16": 0.0}
    rel = {"bfloat16": 0.0}         # largest err / max|plain| in bf16

    def rand(shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda", dtype=dtype)

    def compare(B, H, KH, S, D, pos, dtype):
        q = rand((B, 1, H, D), dtype)
        k, v = rand((B, KH, S, D), dtype), rand((B, KH, S, D), dtype)
        pos_t = torch.as_tensor(pos, dtype=torch.int32, device="cuda")
        out = FD.flash_decode_attention(q, k, v, pos=pos_t)
        torch.cuda.synchronize()
        want = FD.flash_decode_attention_plain(q, k, v, pos=pos_t)
        err = max_diff(out, want)
        name = str(dtype).split(".")[-1]
        if dtype == torch.bfloat16:
            scale = want.float().abs().max().item()
            tol = BF16_RTOL * scale
            rel[name] = max(rel[name], err / scale)
        else:
            tol = FP32_ATOL
        check(math.isfinite(err) and err <= tol,
              f"flash_decode {dtype} B={B} H={H} KH={KH} S={S} D={D} "
              f"pos={pos}: max abs err {err} > {tol}")
        errs[name] = max(errs[name], err)
        return q, k, v, out

    for dtype in (torch.float32, torch.bfloat16):
        for B, H, KH, S, D, pos in GRID:
            compare(B, H, KH, S, D, pos, dtype)
        for pos in FULL_POS:
            compare(FULL["B"], FULL["H"], FULL["KH"], FULL["S"], FULL["D"],
                    pos, dtype)
            compare(ZFULL["B"], ZFULL["H"], ZFULL["KH"], ZFULL["S"],
                    ZFULL["D"], pos, dtype)
        # per-row pos with a dead row: exact zeros there
        rows = [40, 1, 0, 64]
        _, _, _, out = compare(4, 4, 2, 64, 16, rows, dtype)
        check(bool((out[2] == 0).all()), f"pos==0 row not zero ({dtype})")
        # scalar pos == size-1 vector, bit for bit
        q, k, v = rand((1, 1, 4, 16), dtype), rand((1, 2, 64, 16), dtype), \
            rand((1, 2, 64, 16), dtype)
        a = FD.flash_decode_attention(q, k, v, pos=33)
        b = FD.flash_decode_attention(
            q, k, v, pos=torch.tensor([33], dtype=torch.int32, device="cuda"))
        check(torch.equal(a, b), f"size-1 pos vector != scalar ({dtype})")
    print(f"[kernel] flash_decode matches its plain version: max abs err "
          f"{errs}, bf16 at most {rel['bfloat16']:.3e} of max|plain| "
          f"(tolerances f32 {FP32_ATOL}, bf16 {BF16_RTOL} of max|plain|)")

    timed = [time_decode(FD, rand, **FULL), time_decode(FD, rand, **ZFULL)]
    first = timed[0]                # qwen2.5-3b's decode shape
    row = {"name": "flash_decode_attention", "route": "cuda",
           "source": "src/repro_torch/csrc/flash_decode.cu",
           "replaces": "src/repro/kernels/flash_decode.py:94",
           "launches": None, "max_abs_err": max(errs.values()),
           "max_abs_err_by_dtype": errs,
           "ms": first["ms"], "kernel_ms": first["ms"],
           "device_us_per_call": first["device_us_per_call"],
           "host_us_per_call": first["host_us_per_call"],
           "plain_ms": first["plain_ms"], "library_ms": first["library_ms"],
           "library_max_abs_err": first["library_max_abs_err"],
           "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
           "timed_shape": first["shape"],
           "timed_runs_ms": first["runs_ms"], "by_shape": timed}
    return row


def decode_device_us(FD, qs, ks, vs, pos: int, reps: int = 40) -> dict:
    """The flash-decode kernel's device microseconds a call at ``pos``
    (torch.profiler over ``reps`` calls on the rotating caches ``qs``,
    ``ks``, ``vs``), checked to be at most one launch of ``DECODE_KERNEL``
    a call and no other device work.  The trace can lose a kernel's record
    (PERF.md, PR 17 runs F, G), so the mean is over the records it holds."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    n = len(qs)
    pos_t = torch.tensor(pos, dtype=torch.int32, device="cuda")

    def call(i):
        return FD.flash_decode_attention(qs[i % n], ks[i % n], vs[i % n],
                                         pos=pos_t)
    for i in range(3):
        call(i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(reps):
            call(i)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    kern = [e for e in events if DECODE_KERNEL in e.key]
    launches = sum(e.count for e in kern)
    other = [e.key[:60] for e in events if DECODE_KERNEL not in e.key]
    check(0 < launches <= reps and not other,
          f"flash_decode at pos {pos}: {launches} {DECODE_KERNEL} launches "
          f"in {reps} calls, other device work {other}")
    return sum(e.self_device_time_total for e in kern) / launches


def time_decode(FD, rand, B, H, KH, S, D) -> dict:
    """Kernel, plain version and one library call at a full-width decode
    shape, bf16, at the served context length, beside the bound; the
    kernel's device time a call at ``DEVICE_POS`` (torch.profiler) and
    the wrapper's host time a call.  Caches rotate over > 128 MB of
    copies, so every launch finds its cache out of L2 as a decode step
    does (a step streams every layer's weights and caches through L2
    between two visits of one layer)."""
    from repro_torch.core.hardware import H100
    dtype = torch.bfloat16
    per_call = 2 * B * KH * S * D * 2
    n = max(2, -(-128 * 2 ** 20 // per_call))
    qs = [rand((B, 1, H, D), dtype) for _ in range(n)]
    ks = [rand((B, KH, S, D), dtype) for _ in range(n)]
    vs = [rand((B, KH, S, D), dtype) for _ in range(n)]
    pos_t = torch.tensor(TIMED_POS, dtype=torch.int32, device="cuda")
    mask = (torch.arange(S, device="cuda") < TIMED_POS)[None, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def library(i):
        return sdpa(qs[i % n].transpose(1, 2), ks[i % n], vs[i % n],
                    attn_mask=mask, enable_gqa=True)

    def kernel(i):
        return FD.flash_decode_attention(qs[i % n], ks[i % n], vs[i % n],
                                         pos=pos_t)

    # the library call computes the same function: hold it to the kernel
    ref = kernel(0)
    lib_err = max_diff(library(0).transpose(1, 2), ref)
    lib_tol = LIB_RTOL * ref.float().abs().max().item()
    check(lib_err <= lib_tol, f"library yardstick disagrees: {lib_err} > "
                              f"{lib_tol}")
    iters = 200
    # plain, kernel, kernel, plain: compare the two within one call
    plain1 = cuda_ms(lambda i: FD.flash_decode_attention_plain(
        qs[i % n], ks[i % n], vs[i % n], pos=pos_t), iters)
    kern1 = cuda_ms(kernel, iters)
    kern2 = cuda_ms(kernel, iters)
    plain2 = cuda_ms(lambda i: FD.flash_decode_attention_plain(
        qs[i % n], ks[i % n], vs[i % n], pos=pos_t), iters)
    lib_ms = cuda_ms(library, iters)
    # the wrapper's host time a call: enqueue only, the device behind
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(iters):
        kernel(i)
    host_us = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    device_us = {p: decode_device_us(FD, qs, ks, vs, p) for p in DEVICE_POS}
    nbytes = FD.bound_bytes(qs[0], ks[0], TIMED_POS)
    flops = 4 * B * H * TIMED_POS * D
    t_bytes = nbytes / H100.hbm_bw * 1e3
    t_ops = flops / H100.flops * 1e3            # bf16 on the tensor cores
    out = {"shape": {"B": B, "H": H, "KH": KH, "S": S, "D": D,
                     "pos": TIMED_POS, "dtype": "bfloat16"},
           "ms": min(kern1, kern2), "plain_ms": min(plain1, plain2),
           "library_ms": lib_ms, "library_max_abs_err": lib_err,
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "device_us_per_call": device_us, "host_us_per_call": host_us,
           "runs_ms": {"kernel": [kern1, kern2], "plain": [plain1, plain2]}}
    print(f"[kernel] flash_decode full-width bf16 {out['shape']}: kernel "
          f"{out['ms']:.5f} ms, plain {out['plain_ms']:.5f} ms, library "
          f"{lib_ms:.5f} ms (max abs err {lib_err:.3e}), bound "
          f"{out['bound_ms']:.6f} ms ({out['bound_by']}); device time a "
          f"call by pos {device_us} us; wrapper host time a call "
          f"{host_us:.2f} us; n_split "
          f"{FD.split_plan(B, KH, S, FD.row_tile(H // KH)[1])}")
    return out


# tests/test_kernels.py's flash-attention shape grid (non-causal) and mask
# cases; the full-width prefill shapes of qwen2.5-3b: the served prompt and
# the recompute arm's max_seq
FA_SHAPES = [(1, 16, 16, 2, 2, 16), (2, 64, 64, 4, 2, 32),
             (1, 40, 40, 4, 4, 16), (2, 32, 32, 8, 1, 64),
             (1, 33, 65, 2, 2, 8)]
FA_MASKS = [(True, None, 0), (True, 48, 0), (False, 24, 0), (True, None, 7)]
FA_FULL = dict(B=1, H=16, KH=2, D=128)
FA_ZFULL = dict(B=1, H=32, KH=32, D=112)        # zamba2-7b's shared attn
FA_FULL_S = (1024, 2048)


def phase_prefill_kernel(FA, gen) -> dict:
    from repro_torch.core.hardware import H100
    errs = {"float32": 0.0, "bfloat16": 0.0}
    rel = {"bfloat16": 0.0}         # largest err / max|plain| in bf16

    def rand(shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda", dtype=dtype)

    def compare(q, k, v, what, **kw):
        out = FA.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        want = FA.flash_attention_plain(q, k, v, **kw)
        check(out.shape == want.shape and out.dtype == q.dtype,
              f"flash_attention {what}: {out.shape} {out.dtype}")
        err = max_diff(out, want)
        name = str(q.dtype).split(".")[-1]
        if q.dtype == torch.bfloat16:
            scale = want.float().abs().max().item()
            tol = BF16_RTOL * scale
            rel[name] = max(rel[name], err / scale)
        else:
            tol = FP32_ATOL
        check(math.isfinite(err) and err <= tol,
              f"flash_attention {q.dtype} {what} {kw}: max abs err {err} > "
              f"{tol}")
        errs[name] = max(errs[name], err)
        return out

    def inputs(B, Sq, Sk, H, KH, D, dtype):
        return (rand((B, Sq, H, D), dtype), rand((B, Sk, KH, D), dtype),
                rand((B, Sk, KH, D), dtype))

    for dtype in (torch.float32, torch.bfloat16):
        for shape in FA_SHAPES:
            compare(*inputs(*shape, dtype), f"shape {shape}", causal=False)
        for causal, window, q_offset in FA_MASKS:
            compare(*inputs(2, 64, 64 + q_offset, 4, 2, 32, dtype),
                    "mask", causal=causal, window=window, q_offset=q_offset)
        # K/V as sequence-major views of heads-major tensors: strides
        q = rand((1, 100, 16, 128), dtype)
        k, v = rand((1, 2, 100, 128), dtype), rand((1, 2, 100, 128), dtype)
        compare(q, k.transpose(1, 2), v.transpose(1, 2), "strided K/V")
        # zamba2-7b's shared attention: D 112, MHA
        compare(*inputs(1, 70, 70, 4, 4, 112, dtype), "D 112", causal=True)
    for full in (FA_FULL, FA_ZFULL):
        B, H, KH, D = (full[x] for x in ("B", "H", "KH", "D"))
        for S in FA_FULL_S:
            compare(*inputs(B, S, S, H, KH, D, torch.bfloat16),
                    f"full width H={H} KH={KH} D={D} S={S}", causal=True)
        # the recompute arm: queries at 1024 ... 1323 against 1324 keys
        compare(*inputs(B, 300, 1324, H, KH, D, torch.bfloat16),
                f"recompute-shaped H={H} KH={KH} D={D}", causal=True,
                q_offset=1024)
    print(f"[kernel] flash_attention matches its plain version: max abs err "
          f"{errs}, bf16 at most {rel['bfloat16']:.3e} of max|plain| "
          f"(tolerances f32 {FP32_ATOL}, bf16 {BF16_RTOL} of max|plain|)")

    # timing at the full-width shapes, bf16, causal; inputs rotate over
    # > 128 MB of copies, so no launch finds its inputs in the 50 MB L2
    sdpa = torch.nn.functional.scaled_dot_product_attention
    timed = []
    shapes = [(full, S) for full in (FA_FULL, FA_ZFULL) for S in FA_FULL_S]
    for full, S in shapes:
        B, H, KH, D = (full[x] for x in ("B", "H", "KH", "D"))
        per_call = 2 * B * S * (H + KH) * D
        n = max(2, -(-128 * 2 ** 20 // per_call))
        sets = [inputs(B, S, S, H, KH, D, torch.bfloat16) for _ in range(n)]

        def kernel(i):
            return FA.flash_attention(*sets[i % n], causal=True)

        def plain(i):
            return FA.flash_attention_plain(*sets[i % n], causal=True)

        def library(i):
            q, k, v = (t.transpose(1, 2) for t in sets[i % n])
            return sdpa(q, k, v, is_causal=True, enable_gqa=True)

        # the library call computes the same function: hold it to the kernel
        ref = kernel(0)
        lib_err = max_diff(library(0).transpose(1, 2), ref)
        lib_tol = LIB_RTOL * ref.float().abs().max().item()
        check(lib_err <= lib_tol, f"library yardstick disagrees at S={S}: "
                                  f"{lib_err} > {lib_tol}")
        iters = 20
        # plain, kernel, kernel, plain: compare the two within one call
        plain1 = cuda_ms(plain, iters)
        kern1 = cuda_ms(kernel, iters)
        kern2 = cuda_ms(kernel, iters)
        plain2 = cuda_ms(plain, iters)
        lib_ms = cuda_ms(library, iters)
        q, k, _ = sets[0]
        t_ops = FA.bound_flops(q, k, causal=True) / H100.flops * 1e3
        t_bytes = FA.bound_bytes(q, k) / H100.hbm_bw * 1e3
        chain, mean = FA.schedule_chain(B, S, S, H, causal=True,
                                        window=None, q_offset=0)
        timed.append({"S": S, "H": H, "KH": KH, "D": D,
                      "ms": min(kern1, kern2),
                      "plain_ms": min(plain1, plain2), "library_ms": lib_ms,
                      "library_max_abs_err": lib_err,
                      "bound_ms": max(t_bytes, t_ops),
                      "bound_by": "bytes" if t_bytes >= t_ops
                      else "operations",
                      "runs_ms": {"kernel": [kern1, kern2],
                                  "plain": [plain1, plain2]}})
        t = timed[-1]
        print(f"[kernel] flash_attention full-width bf16 causal H={H} "
              f"KH={KH} D={D} S={S}: "
              f"kernel {t['ms']:.5f} ms, plain {t['plain_ms']:.5f} ms, "
              f"library {lib_ms:.5f} ms (max abs err {lib_err:.3e}), bound "
              f"{t['bound_ms']:.6f} ms ({t['bound_by']}); schedule chain "
              f"{chain} key tiles, mean {mean:.2f} a consumer")
        del sets
    first = timed[0]                # qwen2.5-3b's served prompt
    B, H, KH, D = (FA_FULL[x] for x in ("B", "H", "KH", "D"))
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:88",
            "launches": None, "max_abs_err": max(errs.values()),
            "max_abs_err_by_dtype": errs,
            "ms": first["ms"], "plain_ms": first["plain_ms"],
            "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
            "library_ms": first["library_ms"],
            "timed_shape": {"B": B, "S": FA_FULL_S[0], "H": H, "KH": KH,
                            "D": D, "causal": True, "dtype": "bfloat16"},
            "by_shape": timed}


def tally():
    """``(errs, rel, hold)``: ``hold(out, want, what, bf16)`` holds a
    kernel's output against its plain version (f32 to ``FP32_ATOL``, bf16
    to ``BF16_RTOL`` of max |plain|) and keeps the largest error by type
    in ``errs`` and the largest bf16 error over max |plain| in ``rel``."""
    errs = {"float32": 0.0, "bfloat16": 0.0}
    rel = {"bfloat16": 0.0}

    def hold(out, want, what, bf16):
        check(out.shape == want.shape and out.dtype == want.dtype,
              f"{what}: {tuple(out.shape)} {out.dtype}, want "
              f"{tuple(want.shape)} {want.dtype}")
        err = max_diff(out, want)
        key = "bfloat16" if bf16 else "float32"
        if bf16:
            scale = want.float().abs().max().item()
            tol = BF16_RTOL * scale
            rel[key] = max(rel[key], err / scale if scale else 0.0)
        else:
            tol = FP32_ATOL
        check(math.isfinite(err) and err <= tol,
              f"{what}: max abs err {err} > {tol}")
        errs[key] = max(errs[key], err)
    return errs, rel, hold


def time_scan(kernel, plain, n_sets: int, iters: int, plain_iters: int,
              nbytes: int, flops: int, rate: float, exps: int = 0) -> dict:
    """Kernel and plain version (``fn(i)`` on input set ``i % n_sets``),
    timed plain, kernel, kernel, plain by CUDA events, beside the bound:
    the largest of ``nbytes`` over the memory rate, ``flops`` over
    ``rate`` and ``exps`` over the special-function unit's rate
    (``bound_by`` "operations" for either of the last two, named in
    ``bound_term``)."""
    from repro_torch.core.hardware import H100, H100_EXP_RATE
    plain1 = cuda_ms(plain, plain_iters)
    kern1 = cuda_ms(kernel, iters)
    kern2 = cuda_ms(kernel, iters)
    plain2 = cuda_ms(plain, plain_iters)
    terms = {"bytes": nbytes / H100.hbm_bw * 1e3,
             "flops": flops / rate * 1e3,
             "exps": exps / H100_EXP_RATE * 1e3}
    term = max(terms, key=terms.get)
    return {"ms": min(kern1, kern2), "plain_ms": min(plain1, plain2),
            "bound_ms": terms[term],
            "bound_by": "bytes" if term == "bytes" else "operations",
            "bound_term": term, "bound_terms_ms": terms,
            "bound_bytes": nbytes, "bound_flops": flops, "bound_exps": exps,
            "runs_ms": {"kernel": [kern1, kern2], "plain": [plain1, plain2]}}


def launch_device_us(call, reps: int = 5) -> dict:
    """Device microseconds a launch of each CUDA kernel ``call()`` runs
    (torch.profiler over ``reps`` calls after a warm-up), by kernel name
    (template arguments kept, parameters dropped)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    return {e.key.replace("void (anonymous namespace)::", "")
            .split("((")[0]: e.self_device_time_total / e.count
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0}


def scan_row(name, source, replaces, errs, timed) -> dict:
    """The ``kernels`` line's entry of a scan: the decode step's shape
    (S = 1, the most launches on the path) first, the prompt's beside it.
    The bound's modelled terms and exp count stay on the ``[kernel]``
    lines: the ``kernels`` line carries measured numbers and ``bound_ms``."""
    timed = [{k: v for k, v in t.items()
              if k not in ("bound_terms_ms", "bound_exps")} for t in timed]
    first = timed[0]
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": None,
            "max_abs_err": max(errs.values()), "max_abs_err_by_dtype": errs,
            "ms": first["ms"], "plain_ms": first["plain_ms"],
            "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
            # no single PyTorch call computes a selective or SSD scan
            "library_ms": None, "timed_shape": first["shape"],
            "by_seq": timed}


# tests/test_kernels.py's mamba-scan grid (its chunk and block_d have no
# counterpart here) and tests/test_ssd_kernel.py's SSD grid, with ragged
# two-row cases at zamba2's head width (the chunk-parallel path) and for
# mamba1_scan (a ragged last chunk; Di 37: element-wise loads, a ragged
# channel block)
MS_GRID = [(1, 16, 32, 8), (2, 32, 64, 16), (1, 70, 48, 8), (2, 100, 96, 16),
           (2, 90, 37, 8)]
SSD_GRID = [(1, 32, 2, 16, 8), (2, 64, 4, 32, 16), (1, 50, 3, 8, 4),
            (2, 16, 1, 64, 32), (2, 130, 2, 64, 64)]
MS_FULL = dict(Di=8192, N=16, R=256)         # falcon-mamba-7b's layer
SSD_FULL = dict(H=112, P=64, N=64)           # zamba2-7b's layer
SCAN_S = (1, 1024)                           # a decode step, the prompt
LIVE, PADDED = 1024, 2048                    # the recompute arm's scan
# phase 4's switch_a recomputes at this live length: 16 + 8 decode steps
# past the prompt, not a multiple of mamba1_scan's chunk
LIVE_SWITCH = 1048
CONT_ATOL = 1e-5                             # state continuation


def phase_mamba_kernel(MS, gen) -> dict:
    """mamba1_scan against its plain version: the reference grid in f32
    and bf16 (B and C as column views of one projection, as the model's
    split gives them), with and without h0; state continuation within one
    chunk and across chunk boundaries at full width; the full-width decode
    step, prompt and recompute-length scans in f32 and bf16; the masked
    recompute scan at a chunk-aligned and a ragged live length; timings."""
    from repro_torch.core.hardware import H100_F32_FLOPS
    errs, rel, hold = tally()

    def rand(shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device="cuda", dtype=dtype)

    def inputs(B, S, Di, N, dtype, R=8):
        dt = torch.nn.functional.softplus(rand((B, S, Di))).to(dtype)
        dbc = rand((B, S, R + 2 * N), dtype)
        x = rand((B, S, Di), dtype)
        A = -torch.exp(rand((Di, N)) * 0.2)
        return dt, dbc[..., R:R + N], dbc[..., R + N:], x, A

    def compare(args, h0, what):
        y, h = MS.mamba1_scan(*args, h0=h0)
        torch.cuda.synchronize()
        yw, hw = MS.mamba1_scan_plain(*args, h0=h0)
        bf16 = args[3].dtype == torch.bfloat16
        hold(y, yw, f"mamba1_scan y {what}", bf16)
        hold(h, hw, f"mamba1_scan h {what}", bf16)
        return y, h

    def continuation(args, cut):
        y_full, h_full = MS.mamba1_scan(*args)
        y1, h1 = MS.mamba1_scan(*(a[:, :cut] for a in args[:4]), args[4])
        y2, h2 = MS.mamba1_scan(*(a[:, cut:] for a in args[:4]), args[4],
                                h0=h1)
        return max(max_diff(torch.cat([y1, y2], 1), y_full),
                   max_diff(h2, h_full))

    for dtype in (torch.float32, torch.bfloat16):
        for B, S, Di, N in MS_GRID:
            args = inputs(B, S, Di, N, dtype)
            compare(args, None, f"{dtype} {(B, S, Di, N)}")
            compare(args, rand((B, Di, N)), f"{dtype} {(B, S, Di, N)} h0")
    Di, N, R = (MS_FULL[k] for k in ("Di", "N", "R"))
    # tests/test_kernels.py's continuation, [0:32] == [0:16], [16:32] (one
    # chunk), and at full width over four chunks cut at a chunk boundary
    conts = {"reference (1, 32, 32, 8), cut 16":
             continuation(inputs(1, 32, 32, 8, torch.float32), 16),
             f"full width S 256, cut {2 * MS.CHUNK}":
             continuation(inputs(1, 256, Di, N, torch.float32, R),
                          2 * MS.CHUNK)}
    cont = max(conts.values())
    check(cont <= CONT_ATOL, f"mamba1_scan continuation differs: {conts}")
    # every launch plan at full width: the step (one launch, from h0), the
    # prompt and the recompute's max_seq (three launches)
    for dtype in (torch.float32, torch.bfloat16):
        for S in (1, LIVE, PADDED):
            compare(inputs(1, S, Di, N, dtype, R),
                    rand((1, Di, N)) if S == 1 else None,
                    f"full width {dtype} S={S}")
    # the recompute arm: dt = 0 past the live length leaves h as it was,
    # at a chunk-aligned live length and at phase 4's ragged one
    dt, Bc, Cc, x, A = inputs(1, PADDED, Di, N, torch.bfloat16, R)
    for live in (LIVE, LIVE_SWITCH):
        masked = dt.clone()
        masked[:, live:] = 0
        _, h_pad = compare((masked, Bc, Cc, x, A), None,
                           f"masked S={PADDED} live {live}")
        _, h_live = MS.mamba1_scan(masked[:, :live], Bc[:, :live],
                                   Cc[:, :live], x[:, :live], A)
        check(torch.equal(h_pad, h_live),
              f"mamba1_scan: masked steps moved h (live {live})")
    del dt, Bc, Cc, x, A, masked
    print(f"[kernel] mamba1_scan matches its plain version: max abs err "
          f"{errs}, bf16 at most {rel['bfloat16']:.3e} of max|plain| "
          f"(tolerances f32 {FP32_ATOL}, bf16 {BF16_RTOL} of max|plain|); "
          f"continuation {conts} (limit {CONT_ATOL}); masked scans' states "
          f"equal to the live ones' at live {LIVE} and {LIVE_SWITCH}")

    timed = []
    for S in SCAN_S + (PADDED,):
        # the recompute's scan: max_seq steps, dt = 0 past phase 4's live
        # length; its bound counts the exps and operations of live steps
        live = LIVE_SWITCH if S == PADDED else S

        def make():
            one = inputs(1, S, Di, N, torch.bfloat16, R)
            one[0][:, live:] = 0
            return one
        sets = [make()]
        h0 = rand((1, Di, N)) if S == 1 else None
        nbytes = MS.bound_bytes(sets[0][0], sets[0][1], sets[0][3],
                                h0 is not None)
        n = max(2, -(-128 * 2 ** 20 // nbytes))
        sets += [make() for _ in range(n - 1)]
        h0s = [h0 if h0 is None else rand((1, Di, N)) for _ in range(n)]
        x_live = sets[0][3][:, :live]
        t = time_scan(
            lambda i: MS.mamba1_scan(*sets[i % n], h0=h0s[i % n]),
            lambda i: MS.mamba1_scan_plain(*sets[i % n], h0=h0s[i % n]),
            n, 200 if S == 1 else 20, 20 if S == 1 else 2, nbytes,
            MS.bound_flops(x_live, sets[0][1]), H100_F32_FLOPS,
            MS.bound_exps(x_live, sets[0][1]))
        t["shape"] = {"B": 1, "S": S, "live": live, "Di": Di, "N": N,
                      "dtype": "bfloat16", "h0": h0 is not None}
        t["launches_device_us"] = launch_device_us(
            lambda: MS.mamba1_scan(*sets[0], h0=h0s[0]))
        timed.append(t)
        print(f"[kernel] mamba1_scan full-width bf16 S={S} (live {live}): "
              f"kernel {t['ms']:.5f} ms, plain {t['plain_ms']:.5f} ms, "
              f"bound {t['bound_ms']:.6f} ms ({t['bound_term']}; terms "
              f"{t['bound_terms_ms']}, {t['bound_exps']} exps); device us "
              f"a launch "
              f"{t['launches_device_us']}")
        del sets, h0s, x_live
    return scan_row("mamba1_scan", "src/repro_torch/csrc/mamba_scan.cu",
                    "src/repro/kernels/mamba_scan.py:53", errs, timed)


def phase_ssd_kernel(SD, gen) -> dict:
    """ssd_scan against its plain version: the reference grid in f32 and
    bf16 (x, B and C as column views of one projection, as the model's
    split gives them), with and without h0; state continuation; the
    full-width decode step, prompt and masked recompute scan; timings."""
    from repro_torch.core.hardware import H100
    errs, rel, hold = tally()

    def rand(shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device="cuda", dtype=dtype)

    def inputs(B, S, H, P, N, dtype):
        dt = torch.nn.functional.softplus(rand((B, S, H)))
        xbc = rand((B, S, H * P + 2 * N), dtype)
        x = xbc[..., :H * P].reshape(B, S, H, P)
        A = -torch.exp(rand((H,)) * 0.3)
        return dt, xbc[..., H * P:H * P + N], xbc[..., H * P + N:], x, A

    def compare(args, h0, what):
        y, h = SD.ssd_scan(*args, h0=h0)
        torch.cuda.synchronize()
        yw, hw = SD.ssd_scan_plain(*args, h0=h0)
        bf16 = args[3].dtype == torch.bfloat16
        hold(y, yw, f"ssd_scan y {what}", bf16)
        hold(h, hw, f"ssd_scan h {what}", bf16)
        return y, h

    for dtype in (torch.float32, torch.bfloat16):
        for B, S, H, P, N in SSD_GRID:
            args = inputs(B, S, H, P, N, dtype)
            # the reference grid's dt is in the input dtype
            args = (args[0].to(dtype),) + args[1:]
            compare(args, None, f"{dtype} {(B, S, H, P, N)}")
            compare(args, rand((B, H, P, N)),
                    f"{dtype} {(B, S, H, P, N)} h0")
    def continuation(args, cut):
        y_full, h_full = SD.ssd_scan(*args)
        y1, h1 = SD.ssd_scan(*(a[:, :cut] for a in args[:4]), args[4])
        y2, h2 = SD.ssd_scan(*(a[:, cut:] for a in args[:4]), args[4],
                             h0=h1)
        return max(max_diff(torch.cat([y1, y2], 1), y_full),
                   max_diff(h2, h_full))

    H, P, N = (SSD_FULL[k] for k in ("H", "P", "N"))
    # tests/test_ssd_kernel.py's continuation, [0:32] == [0:16], [16:32]
    # (the sequential kernel), and across a chunk boundary at full width
    # (the chunk-parallel launches)
    cont = max(continuation(inputs(1, 32, 2, 8, 4, torch.float32), 16),
               continuation(inputs(1, 256, H, P, N, torch.float32), 128))
    check(cont <= CONT_ATOL, f"ssd_scan continuation differs by {cont}")
    # every path at full width: the step, one chunk, and more (65: a
    # ragged second chunk; the prompt)
    for dtype in (torch.float32, torch.bfloat16):
        for S in (1, 64, 65, 1024):
            for h0 in (None, rand((1, H, P, N))):
                compare(inputs(1, S, H, P, N, dtype), h0,
                        f"full width {dtype} S={S} h0={h0 is not None}")
    dt, Bc, Cc, x, A = inputs(1, PADDED, H, P, N, torch.bfloat16)
    dt[:, LIVE:] = 0
    _, h_pad = compare((dt, Bc, Cc, x, A), None, f"masked S={PADDED}")
    _, h_live = SD.ssd_scan(dt[:, :LIVE], Bc[:, :LIVE], Cc[:, :LIVE],
                            x[:, :LIVE], A)
    check(torch.equal(h_pad, h_live), "ssd_scan: masked steps moved h")
    print(f"[kernel] ssd_scan matches its plain version: max abs err "
          f"{errs}, bf16 at most {rel['bfloat16']:.3e} of max|plain| "
          f"(tolerances f32 {FP32_ATOL}, bf16 {BF16_RTOL} of max|plain|); "
          f"continuation {cont:.3e} (limit {CONT_ATOL}); masked scan's "
          f"state equal to the live one's")

    timed = []
    for S in SCAN_S:
        one = inputs(1, S, H, P, N, torch.bfloat16)
        h0 = rand((1, H, P, N)) if S == 1 else None
        nbytes = SD.bound_bytes(one[0], one[1], one[3], h0 is not None)
        n = max(2, -(-128 * 2 ** 20 // nbytes))
        sets = [one] + [inputs(1, S, H, P, N, torch.bfloat16)
                        for _ in range(n - 1)]
        h0s = [h0 if h0 is None else rand((1, H, P, N)) for _ in range(n)]
        # bf16 inputs: the chunked form's products could run on the
        # tensor cores, so the least time takes their rate
        t = time_scan(
            lambda i: SD.ssd_scan(*sets[i % n], h0=h0s[i % n]),
            lambda i: SD.ssd_scan_plain(*sets[i % n], h0=h0s[i % n]),
            n, 200 if S == 1 else 20, 20 if S == 1 else 2, nbytes,
            SD.bound_flops(one[3], one[1]), H100.flops)
        t["shape"] = {"B": 1, "S": S, "H": H, "P": P, "N": N,
                      "dtype": "bfloat16", "h0": h0 is not None}
        timed.append(t)
        print(f"[kernel] ssd_scan full-width bf16 S={S}: kernel "
              f"{t['ms']:.5f} ms, plain {t['plain_ms']:.5f} ms, bound "
              f"{t['bound_ms']:.6f} ms ({t['bound_by']})")
        del sets, h0s
    # one chunk (S 64) at full width: the chunk-parallel launches that
    # every S > 1 takes there, against the general-width sequential kernel
    one = inputs(1, SD.CHUNK, H, P, N, torch.bfloat16)
    n = max(2, -(-128 * 2 ** 20 // SD.bound_bytes(one[0], one[1], one[3],
                                                   False)))
    sets = [one] + [inputs(1, SD.CHUNK, H, P, N, torch.bfloat16)
                    for _ in range(n - 1)]

    def call(i):
        return SD.ssd_scan(*sets[i % n])
    chunked1 = cuda_ms(call, 20)
    with forced_path(SD, "sequential"):
        seq1 = cuda_ms(call, 20)
        seq2 = cuda_ms(call, 20)
    chunked2 = cuda_ms(call, 20)
    del sets
    one_chunk = {"chunked": [chunked1, chunked2],
                 "sequential": [seq1, seq2]}
    print(f"[kernel] ssd_scan full-width bf16 S={SD.CHUNK}: chunk-parallel "
          f"{min(chunked1, chunked2):.5f} ms, sequential kernel "
          f"{min(seq1, seq2):.5f} ms")
    row = scan_row("ssd_scan", "src/repro_torch/csrc/ssd_scan.cu",
                   "src/repro/kernels/ssd_scan.py:67", errs, timed)
    row["one_chunk_ms"] = one_chunk
    return row


@contextlib.contextmanager
def forced_path(SD, kind: str):
    """Every ``SD.ssd_scan`` call takes path ``kind`` while open (a timing
    comparison; the wrapper picks the path from the shape otherwise)."""
    real = SD.path
    SD.path = lambda S, P, N: kind
    try:
        yield
    finally:
        SD.path = real


# ---------------------------------------------------------------------------
# launch counts of the main paths
# ---------------------------------------------------------------------------

class Counts:
    """The kernels' launch counters (``fn.launches`` of each wrapper),
    read together by kernel name."""

    def __init__(self, wrappers: dict):
        self.wrappers = wrappers

    def reset(self) -> None:
        for fn in self.wrappers.values():
            fn.launches = 0

    def read(self) -> dict:
        return {name: fn.launches for name, fn in self.wrappers.items()}

    def since(self, before: dict) -> dict:
        now = self.read()
        return {name: now[name] - before[name] for name in now}


@contextlib.contextmanager
def counted(K: Counts, obj, name: str, log: list):
    """Append to ``log`` the kernel launches of every call of ``obj.name``
    (a class's method or an instance's) while the context is open."""
    fn = getattr(obj, name)

    def wrapper(*args, **kwargs):
        before = K.read()
        out = fn(*args, **kwargs)
        log.append(K.since(before))
        return out
    setattr(obj, name, wrapper)
    try:
        yield log
    finally:
        if isinstance(obj, type):
            setattr(obj, name, fn)
        else:
            delattr(obj, name)


def shut(mgr) -> None:
    """Stop a manager's pool and close every pipeline it built, so that
    its weight copies (a Scenario-A standby owns one, pause_resume reloads
    one) are freed now: the pool's objects refer to each other, and the
    garbage collector would find them late."""
    mgr.close()
    for key in list(mgr.pool.keys()):
        mgr.pool.get(key).pipeline.close()


def expected(K: Counts, cfg, lo: int, hi: int, mode: str) -> dict:
    """Launches one pass over layers [lo, hi) must make: ``mode`` "decode"
    (one token) or "full" (a prefill, a recompute or a stateless request):
    one attention kernel per attention unit (flash_decode in a decode step,
    flash_attention in a full pass; the hybrid family's shared-attention
    applications among them) and one scan kernel per mamba layer."""
    from repro_torch.core.stateful import unit_index_of_split, unit_list
    units = unit_list(cfg)[unit_index_of_split(cfg, lo):
                           unit_index_of_split(cfg, hi)]
    attn = sum(1 for kind, _ in units if kind == "app"
               or cfg.family == "dense")
    out = dict.fromkeys(K.wrappers, 0)
    out["flash_decode_attention" if mode == "decode"
        else "flash_attention"] = attn
    if len(units) > attn:
        out["mamba1_scan" if cfg.ssm.kind == "mamba1"
            else "ssd_scan"] = len(units) - attn
    return out


def scaled(counts: dict, k: int) -> dict:
    return {name: k * n for name, n in counts.items()}


def device_kernels(cfg) -> tuple:
    """Parts of the names of the CUDA kernels of the family's main path
    (profiler): the prefill attention's (``flash_attention_hopper_kernel``
    in bf16), flash-decode's one (``DECODE_KERNEL``), and the scan's
    (mamba1_scan's chunk and carry kernels all carry ``mamba1_``;
    ssd_scan's three chunk-parallel passes, its decode step and its
    sequential kernel ``ssd_``)."""
    names = ["flash_attention_", DECODE_KERNEL]
    if cfg.ssm is not None:
        names.append("mamba1_" if cfg.ssm.kind == "mamba1" else "ssd_")
    return tuple(names)


def decode_registers(log) -> dict:
    """``{"<type>,<rows>": [registers, spill store bytes, spill load
    bytes]}`` of each flash-decode instantiation, from ptxas's report in
    the build's ``nvcc.log``."""
    import re
    out, name = {}, None
    for line in open(log):
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"flash_decode_kernelI(13__nv_bfloat16|f)Li(\d+)E",
                          m.group(1))
            name = (f"{'bf16' if k.group(1) != 'f' else 'f32'},"
                    f"{k.group(2)}") if k else None
        elif name and "spill stores" in line:
            spills = [int(x) for x in re.findall(r"(\d+) bytes spill", line)]
        elif name and "Used" in line and "registers" in line:
            regs = int(re.search(r"Used (\d+) registers", line).group(1))
            out[name] = [regs] + spills
            name = None
    return out


# ---------------------------------------------------------------------------
# what a switch's downtime could hide
# ---------------------------------------------------------------------------

def smi_clocks() -> str:
    """The card's SM clock and its active clock-event (throttle) reasons."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,"
                          "clocks_throttle_reasons.active",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, timeout=60)
    return (out.stdout or out.stderr).strip()


def rss_bytes() -> int:
    """The process's resident set, from ``/proc/self/statm``."""
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


class GcLog:
    """Every garbage collection of the process, from ``gc.callbacks``:
    (start on the ``perf_counter`` clock, generation, seconds, ``label``
    as it stood: the phase the script was in, objects found unreachable,
    resident bytes the collection gave back)."""

    def __init__(self):
        self.events = []
        self.label = "start"
        self._t0 = None
        self._rss0 = 0
        self._origin = time.perf_counter()
        gc.callbacks.append(self._on_gc)

    def _on_gc(self, phase, info):
        now = time.perf_counter()
        if phase == "start":
            self._t0, self._rss0 = now, rss_bytes()
        elif self._t0 is not None:
            self.events.append((self._t0, info["generation"],
                                now - self._t0, self.label,
                                info["collected"],
                                self._rss0 - rss_bytes()))
            self._t0 = None

    def offset(self, t: float) -> float:
        """``t`` (``perf_counter``) in seconds into the log, as
        ``summary`` gives a collection's start."""
        return round(t - self._origin, 3)

    def between(self, t0: float, t1: float) -> list:
        return [(g, s) for t, g, s, *_ in self.events if t0 <= t < t1]

    def summary(self) -> dict:
        """Counts, and each full (generation-2) collection as (phase,
        seconds into the script, seconds it took, objects it found
        unreachable, resident MB it gave back)."""
        full = [(label, self.offset(t), s, n, round(freed / 2 ** 20, 1))
                for t, g, s, label, n, freed in self.events if g == 2]
        return {"collections": len(self.events), "gen2": len(full),
                "gen2_max_s": max((e[2] for e in full), default=0.0),
                "gen2_total_s": sum(e[2] for e in full),
                "gen2_events": full}


ALLOC_KEYS = ("num_device_alloc", "num_device_free", "num_alloc_retries",
              "num_sync_all_streams")


def host_counters() -> dict:
    """The calling thread's user and system CPU seconds and page faults
    (``getrusage``), and the machine's CPU seconds stolen by its
    hypervisor (``/proc/stat``'s steal column, all CPUs)."""
    ru = resource.getrusage(resource.RUSAGE_THREAD)
    with open("/proc/stat") as f:
        cpu = f.readline().split()
    steal = int(cpu[8]) / os.sysconf("SC_CLK_TCK") if len(cpu) > 8 else 0.0
    return {"user_s": ru.ru_utime, "sys_s": ru.ru_stime,
            "minor_faults": ru.ru_minflt, "major_faults": ru.ru_majflt,
            "steal_s": steal}


def host_delta(c0: dict, c1: dict) -> dict:
    return {k: c1[k] - c0[k] for k in c0}


@contextlib.contextmanager
def switch_probe(mgr, session, gclog: GcLog):
    """Read around one repartition, into the dict it yields: the recompute
    hand-off's host dispatch and its span on the device (CUDA events on the
    session's stream from before the first launch to after the last), the
    serving thread's wall, CPU time and context switches over the switch,
    the caching allocator's counters across it, the garbage collections
    inside it and when it started (``GcLog``'s clock), the live threads and
    pending builds before it, the SM clock and throttle reasons before and
    after, and ``host_counters`` across each recompute's dispatch."""
    rec = {"clocks_before": smi_clocks(),
           "threads": sorted(t.name for t in threading.enumerate()),
           "pending_builds": mgr.pool.pending_builds(),
           "loadavg": os.getloadavg(), "recomputes": []}
    runner = session.runner
    real = runner.recompute_fn

    def timed(u0, u1):
        fn = real(u0, u1)

        def run(*args):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            c0 = host_counters()
            t0 = time.perf_counter()
            start.record()
            out = fn(*args)
            end.record()
            rec["recomputes"].append(
                {"dispatch_s": time.perf_counter() - t0, "events": (start,
                                                                    end),
                 "host": host_delta(c0, host_counters())})
            return out
        return run
    runner.recompute_fn = timed
    mem0 = torch.cuda.memory_stats()
    ru0 = resource.getrusage(resource.RUSAGE_THREAD)
    cpu0, t0 = time.thread_time(), time.perf_counter()
    try:
        yield rec
    finally:
        t1 = time.perf_counter()
        cpu = time.thread_time() - cpu0
        ru1 = resource.getrusage(resource.RUSAGE_THREAD)
        del runner.recompute_fn
        mem1 = torch.cuda.memory_stats()
        torch.cuda.synchronize()
        for r in rec["recomputes"]:
            start, end = r.pop("events")
            r["device_span_s"] = start.elapsed_time(end) / 1e3
        rec.update({
            "at_s": gclog.offset(t0), "wall_s": t1 - t0, "thread_cpu_s": cpu,
            "involuntary_ctx_switches": ru1.ru_nivcsw - ru0.ru_nivcsw,
            "voluntary_ctx_switches": ru1.ru_nvcsw - ru0.ru_nvcsw,
            "alloc": {k: mem1.get(k, 0) - mem0.get(k, 0) for k in ALLOC_KEYS},
            "gc": gclog.between(t0, t1), "clocks_after": smi_clocks()})


# ---------------------------------------------------------------------------
# phase 4: the stateful decode path
# ---------------------------------------------------------------------------

PROMPT, MAX_SEQ = 1024, 2048


def phase_slice(K, cfg, params, kw, splits, gclog: GcLog) -> tuple:
    """Prompt ``PROMPT``, ``max_seq`` ``MAX_SEQ``, 16 decode steps at
    ``splits[0]``, then switch_b2, switch_a and pause_resume through
    ``splits[1:]`` with 8 steps after each, on a 5 Mbps link after the
    first 16 steps; checks every kernel's launches per decode step, per
    prefill forward and per recompute hand-off, the downtime ordering,
    finite logits, and an unswitched session fed the same tokens."""
    from repro_torch.core.network import NetworkModel
    from repro_torch.core.stateful import DecodeSession, make_stateful_manager

    L = cfg.num_layers
    per_step = expected(K, cfg, 0, L, "decode")
    per_forward = expected(K, cfg, 0, L, "full")
    # --- the main path, with the launch counts read around it ---------
    K.reset()
    sw = time.perf_counter()
    with counted(K, DecodeSession, "prefill", []) as prefills:
        mgr, session = make_stateful_manager(cfg, params, split=splits[0],
                                             **kw)
    check(mgr.runner.resolved_decode_impl == "kernel",
          f"decode_impl auto resolved to {mgr.runner.resolved_decode_impl}")
    # DecodeSession.prefill runs the stack twice (the second run times the
    # host's recompute throughput, as the reference's does)
    check(prefills == [scaled(per_forward, 2)],
          f"the prefill launched {prefills}, want "
          f"{scaled(per_forward, 2)} (two forwards)")
    print(f"[slice] {cfg.name}: {L} layers, d_model {cfg.d_model}, bf16, "
          f"prompt {PROMPT}, max_seq {MAX_SEQ}; set-up "
          f"{time.perf_counter() - sw:.2f} s; prefill launched "
          f"{prefills[0]}; objects the garbage collector tracks "
          f"{len(gc.get_objects())} (frozen {gc.get_freeze_count()})")

    logits_seen = []
    step_ms = []            # edge + cloud wall of a step, unscaled
    recomputes = []         # launches of each recompute hand-off
    probes = {}             # switch_probe's readings of each switch

    def serve(n: int, per_step_check: bool):
        edge_scale = mgr.active.edge_scale
        for _ in range(n):
            before = K.read()
            logits, timing = mgr.serve(None)
            step_ms.append((timing.t_edge / edge_scale + timing.t_cloud)
                           * 1e3)
            if per_step_check:
                got = K.since(before)
                check(got == per_step, f"a decode step launched {got}, "
                                       f"want {per_step}")
            logits_seen.append(logits.float().cpu())

    def repartition(strategy, split):
        log = []
        done = len(mgr.pool.handoffs)
        with switch_probe(mgr, session, gclog) as probe:
            with counted(K, session, "recompute_layers", log):
                rep = mgr.repartition(strategy, split)
        probe["downtime_s"] = rep.downtime
        probe["handoff_wall_s"] = [h.t_wall for h in mgr.pool.handoffs[done:]]
        probes[strategy] = probe
        lo = min(rep.old_split, rep.new_split)
        hi = max(rep.old_split, rep.new_split)
        want = [expected(K, cfg, lo, hi, "full")] \
            if rep.handoff_mode == "recompute" else []
        check(log == want, f"{strategy} {rep.old_split} -> {rep.new_split} "
                           f"({rep.handoff_mode}): the hand-off launched "
                           f"{log}, want {want}")
        recomputes.extend(log)
        return rep

    t0 = time.perf_counter()
    serve(16, per_step_check=True)
    mgr.set_network(NetworkModel(5.0))
    rep_b2 = repartition("switch_b2", splits[1])
    serve(8, per_step_check=True)
    mgr.build_standby(splits[2])
    rep_a = repartition("switch_a", splits[2])
    serve(8, per_step_check=False)       # the old split's standby rebuilds
    rep_pr = repartition("pause_resume", splits[3])
    serve(8, per_step_check=True)
    mgr.drain()
    launches = K.read()
    wall = time.perf_counter() - t0
    for name, n in per_step.items():
        check(launches[name] >= 40 * n, f"{name} launched {launches[name]} "
                                        f"times over 40 decode steps")
    for rep in (rep_b2, rep_a, rep_pr):
        print(f"[slice] {rep.strategy}: split {rep.old_split} -> "
              f"{rep.new_split}, downtime {rep.downtime:.6f} s, hand-off "
              f"{rep.handoff_mode} ({rep.t_handoff:.6f} s, "
              f"{rep.handoff_bytes} B)")
        print(f"[slice] {rep.strategy} probe: {probes[rep.strategy]}")
    print(f"[slice] launches: {launches} on the path; per decode step "
          f"{per_step}; hand-offs' recomputes {recomputes}")
    check(rep_pr.downtime > rep_b2.downtime > rep_a.downtime,
          "downtime ordering pause_resume > switch_b2 > switch_a violated")
    check(all(bool(torch.isfinite(x).all()) for x in logits_seen),
          "non-finite logits")
    ckpt = mgr.pool.checkpoint_path       # phase 6 reloads it too
    tokens = session.tokens.clone()
    shut(mgr)

    # --- an unswitched session fed the same tokens --------------------
    ref, ref_session = make_stateful_manager(cfg, params, split=splits[0],
                                             **kw)
    check(torch.equal(ref_session.tokens, tokens[:, :PROMPT]),
          "reference prompt differs")
    ref_logits, diffs = [], []
    for i in range(40):
        feed = {"token": tokens[:, PROMPT + i:PROMPT + 1 + i]}
        if i == 16:
            logits, prof = profile_step(lambda: ref.serve(feed)[0],
                                        request_bound_ms(cfg, params, 1),
                                        device_kernels(cfg))
            # the step's launches must show in the trace with device time
            # (a renamed kernel would otherwise read as 0), and no more of
            # them than the wrapper made; the trace can lose a record
            # (PERF.md, PR 17 runs A, F, G), so fewer are not held
            want = per_step["flash_decode_attention"]
            got = prof.get("kernel_calls", {}).get(DECODE_KERNEL, 0)
            check(not want or (0 < got <= want and prof[
                "kernel_device_ms_by_name"][DECODE_KERNEL] > 0),
                f"the profiled step shows {got} {DECODE_KERNEL} launches "
                f"with device time, want {want} (host kernel launches vs "
                f"records traced: {prof.get('kernel_launches_vs_records')}; "
                f"{prof.get('error', '')})")
        else:
            logits, _ = ref.serve(feed)
        ref_logits.append(logits.float().cpu())
        diffs.append(max_diff(ref_logits[-1], logits_seen[i]))
    shut(ref)
    scale = max(x.abs().max().item() for x in logits_seen)
    pre = max(diffs[:16])
    post = max(diffs[16:])
    print(f"[slice] unswitched session: max |logit diff| before the first "
          f"switch {pre:.3e}, after {post:.3e} (max |logit| {scale:.3e})")
    # before any switch both streams run the same kernels on the same
    # inputs: bit-exact.  The recompute arm rebuilds the moved layers'
    # state with prefill-shaped matmuls whose bf16 rounding differs from
    # the decode steps', so after it the logits agree to bf16 precision
    # only (phase 5 holds the recomputed state itself to a limit that
    # planted faults fail).
    check(pre == 0.0, f"logits differ before any switch: {pre}")
    check(post <= LOGIT_RTOL * scale, f"logits after switches differ by "
                                      f"{post} (> {LOGIT_RTOL} of {scale})")
    med = sorted(step_ms[:16])[8]
    print(f"[slice] decode step (edge + cloud wall, split {splits[0]}): "
          f"median {med:.3f} ms over the first 16 steps; profiled step: "
          f"{prof}")
    out = {"launches": launches, "launches_per_step": per_step,
           "launches_per_prefill": prefills[0],
           "launches_per_recompute": recomputes,
           "wall_s": wall, "step_ms_median_first16": med, "step_ms": step_ms,
           "profiled_step": prof,
           "downtime_s": {"switch_b2": rep_b2.downtime,
                          "switch_a": rep_a.downtime,
                          "pause_resume": rep_pr.downtime},
           "handoff": {"switch_b2": rep_b2.handoff_mode,
                       "switch_a": rep_a.handoff_mode,
                       "pause_resume": rep_pr.handoff_mode},
           "switch_probes": probes,
           "logit_diff": {"before_switch": pre, "after_switch": post,
                          "max_abs_logit": scale}}
    return out, tokens, ref_logits, ckpt


def request_bound_ms(cfg, params, tokens: int, extra_flops: int = 0) -> float:
    """Least time the card could take for one request of ``tokens`` tokens:
    the larger of every weight read once from device memory and the
    matrix products' operations (2 a weight a token: every layer matrix,
    the shared block's once per application, the LM head; plus
    ``extra_flops``, the attention's) at the bf16 peak."""
    from repro_torch.core.hardware import H100
    from repro_torch.core.stages import tree_leaves
    nbytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    not_products = ("A_log", "conv_w")

    def matrices(tree, dims):
        return sum(t.numel() for k, t in flat(tree)
                   if t.dim() == dims and k not in not_products)

    def flat(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v)
            else:
                yield k, v
    matmul = matrices(params["layers"], 3)
    if "shared" in params:
        matmul += matrices(params["shared"], 2) * (cfg.num_layers
                                                   // cfg.hybrid_period)
    matmul += params.get("lm_head", params["embed"]).numel()
    flops = 2 * tokens * matmul + extra_flops
    return max(nbytes / H100.hbm_bw, flops / H100.flops) * 1e3


def profile_step(call, bound_ms, kernel_keys):
    """One request (``call()`` returns its logits) under torch.profiler:
    device busy time (the sum of the kernels' and copies' own device time,
    counted once each), idle share of the request's wall, the device ops
    (kernels and copies) and the aten operators it ran, the kernel
    launches the host made beside the kernel records traced, the device time,
    launches and share of the kernels whose names contain one of
    ``kernel_keys``, and busy time over the request's bound ``bound_ms``
    (``request_bound_ms``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    logits = None
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            logits = call()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    except RuntimeError as e:           # the profiler, not the step, failed
        print(f"[profile] profiler unavailable: {e!r}", file=sys.stderr)
        if logits is None:
            logits = call()
        return logits, {"error": repr(e)}

    # a CPU op's device time repeats the time of the kernels it launched,
    # which appear as CUDA events of their own: count the CUDA events only
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and not e.is_user_annotation and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in events)
    by_kernel = {key: sum(e.self_device_time_total for e in events
                          if key in e.key) / 1e3 for key in kernel_keys}
    calls = {key: sum(e.count for e in events if key in e.key)
             for key in kernel_keys}
    aten = sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CPU
               and e.key.startswith("aten::"))
    # kernel launches the host made against kernel records the trace holds
    # (copies and memsets aside): a shortfall of records is the trace's
    api = sum(e.count for e in prof.key_averages()
              if e.key.startswith(("cudaLaunchKernel", "cuLaunchKernel")))
    records = sum(e.count for e in events
                  if not e.key.startswith(("Memcpy", "Memset")))
    kern = sum(by_kernel.values()) * 1e3
    bound_us = bound_ms * 1e3
    top = sorted(events, key=lambda e: e.self_device_time_total,
                 reverse=True)[:6]
    return logits, {
        "wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
        "idle_share": max(0.0, 1.0 - busy / wall_us) if wall_us else None,
        "device_ops": sum(e.count for e in events), "aten_ops": aten,
        "kernel_launches_vs_records": [api, records],
        "kernel_device_ms": kern / 1e3, "kernel_device_ms_by_name": by_kernel,
        "kernel_calls": calls,
        "kernel_device_us_per_launch": {
            key: by_kernel[key] * 1e3 / calls[key]
            for key in kernel_keys if calls[key]},
        "kernel_share_of_busy": kern / busy if busy else None,
        "bound_ms": bound_ms,
        "busy_over_bound": busy / bound_us,
        "top_device_ms": {e.key[:60]: e.self_device_time_total / 1e3
                          for e in top}}


# ---------------------------------------------------------------------------
# phase 5: both hand-off arms, and planted faults
# ---------------------------------------------------------------------------

def state_readings(moved: dict, truth: dict, pos: int) -> dict:
    """Max |diff| of the moved layers' state from ``truth``, by kind, over
    max |truth| of that kind: ``kv`` (live rows of attention caches),
    ``conv`` and ``ssm`` (recurrent state)."""
    from repro_torch.core.stateful import _is_kv
    diff, scale = {}, {}
    for key, t in truth.items():
        kind = "kv" if _is_kv(key) else key.rstrip("0123456789")
        got = moved[key][:, :, :pos] if kind == "kv" else moved[key]
        diff[kind] = max(diff.get(kind, 0.0), max_diff(got, t))
        scale[kind] = max(scale.get(kind, 0.0),
                          t.float().abs().max().item())
    return {kind: diff[kind] / scale[kind] for kind in diff}


def phase_handoff(K, cfg, params, kw, tokens, ref_logits, splits) -> dict:
    """Replays the main path's tokens through a third session: 16 steps at
    ``splits[0]``, a switch_b2 to ``splits[1]`` pinned to the transfer arm,
    8 steps, then a switch_b2 back pinned to the recompute arm, read three
    ways from the same post-switch state: sound, stale (the moved layers'
    state as it stood at the transfer switch, 8 steps before: recurrent
    state from then, KV rows since zeroed) and lost (all zeros).  Each is
    read as the moved layers' state against the state the decode steps
    wrote (``state_readings``), and as the logits of the next 8 steps
    against the unswitched session's."""
    from repro_torch.core.stateful import _is_kv, make_stateful_manager
    mgr, s = make_stateful_manager(cfg, params, split=splits[0], **kw)
    scale = max(x.abs().max().item() for x in ref_logits)
    lo, hi = splits[1], splits[0]

    def serve(i0, n) -> float:
        worst = 0.0
        for i in range(i0, i0 + n):
            logits, _ = mgr.serve(
                {"token": tokens[:, PROMPT + i:PROMPT + 1 + i]})
            worst = max(worst, max_diff(logits.cpu(), ref_logits[i]))
        return worst

    check(serve(0, 16) == 0.0, "logits differ before any switch")
    mgr.pool.force_mode = "transfer"
    rep_t = mgr.repartition("switch_b2", lo)
    check(rep_t.handoff_mode == "transfer" and rep_t.handoff_bytes > 0,
          f"pinned transfer switch ran {rep_t.handoff_mode}, "
          f"{rep_t.handoff_bytes} B")
    stale_pos = s.pos
    stale = {k: t.clone() for k, t in s.subset(lo, hi).items()}
    d_transfer = serve(16, 8)
    print(f"[handoff] transfer arm: split {rep_t.old_split} -> "
          f"{rep_t.new_split}, {rep_t.handoff_bytes} B, hand-off "
          f"{rep_t.t_handoff:.6f} s (measured wall + the bytes' priced "
          f"link time); max |logit diff| {d_transfer:.3e}")
    # the payload carries the moved layers' state bits unchanged
    check(d_transfer == 0.0, f"logits differ after a transfer hand-off: "
                             f"{d_transfer}")

    # the moved layers' state as the decode steps wrote it: the state the
    # recompute arm must rebuild (both stages share one card)
    truth = {k: (t[:, :, :s.pos] if _is_kv(k) else t).clone()
             for k, t in s.subset(lo, hi).items()}
    mgr.pool.force_mode = "recompute"
    log = []
    with counted(K, s, "recompute_layers", log):
        rep_r = mgr.repartition("switch_b2", hi)
    check(rep_r.handoff_mode == "recompute",
          f"pinned recompute switch ran {rep_r.handoff_mode}")
    want = expected(K, cfg, lo, hi, "full")
    check(log == [want], f"the recompute hand-off launched {log}, want "
                         f"[{want}]")
    pos = s.pos
    snap = s.snapshot()
    readings, logit = {}, {}
    for name in ("sound", "stale", "lost"):
        s.restore(snap)
        moved = s.subset(lo, hi)
        for key, t in moved.items():
            if name == "lost":
                t.zero_()
            elif name == "stale":
                if _is_kv(key):
                    t[:, :, stale_pos:pos].zero_()
                else:
                    t.copy_(stale[key])
        readings[name] = state_readings(moved, truth, pos)
        logit[name] = serve(24, 8)
    shut(mgr)
    # the state whose faults must show: the SSM state where the family has
    # one, the KV of the attention layers otherwise
    primary = "ssm" if "ssm" in readings["sound"] else "kv"
    logit_limit = LOGIT_RTOL * scale
    print(f"[handoff] recompute arm: split {rep_r.old_split} -> "
          f"{rep_r.new_split}; launched {log[0]}; moved layers' state, max "
          f"|diff| over max |decode-written| by kind: {readings} (limit "
          f"{STATE_RTOL}); max |logit diff| over the next 8 steps: {logit} "
          f"(limit {logit_limit:.3e})")
    for kind, r in readings["sound"].items():
        check(r <= STATE_RTOL, f"recomputed {kind} state differs by {r} of "
                               f"its max (> {STATE_RTOL})")
    check(logit["sound"] <= logit_limit, f"logits after a recompute "
                                         f"hand-off differ by "
                                         f"{logit['sound']}")
    for fault in ("stale", "lost"):
        r = readings[fault][primary]
        check(r > STATE_RTOL, f"the {primary} limit {STATE_RTOL} does not "
                              f"catch {fault} state ({r})")
    return {"transfer": {"bytes": rep_t.handoff_bytes,
                         "t_handoff_s": rep_t.t_handoff,
                         "max_abs_logit_diff": d_transfer},
            "recompute": {"launches": log[0],
                          "state_rel_diff": readings,
                          "state_limit": STATE_RTOL,
                          "max_abs_logit_diff": logit,
                          "logit_limit": logit_limit}}


# ---------------------------------------------------------------------------
# phase 6: the stateless path at full width
# ---------------------------------------------------------------------------

def phase_stateless(K, cfg, params, ckpt, seed, splits) -> dict:
    """One ``PROMPT``-token prompt through the stateless edge-cloud
    pipeline at unit split ``splits[0]`` (embedding + that many layers on
    the edge), then switch_b2, switch_a and pause_resume (reloading phase
    4's checkpoint) through ``splits[1:]``, with one request after each
    switch."""
    from repro_torch.core.network import NetworkModel
    from repro_torch.core.stages import StageRunner
    from repro_torch.core.switching import PipelineManager
    from repro_torch.kernels import flash_attention as FA

    L = cfg.num_layers
    per_request = expected(K, cfg, 0, L, "full")
    gen = torch.Generator().manual_seed(seed + 2)
    prompt = {"tokens": torch.randint(0, cfg.vocab_size, (1, PROMPT),
                                      generator=gen).cuda()}
    request_ms = []         # edge + cloud wall of a request, unscaled

    def serve():
        before = K.read()
        logits, timing = mgr.serve(prompt)
        torch.cuda.synchronize()
        got = K.since(before)
        check(got == per_request, f"a request launched {got}, want "
                                  f"{per_request}")
        request_ms.append((timing.t_edge / mgr.active.edge_scale
                           + timing.t_cloud) * 1e3)
        return logits

    # --- the main path, with the launch counts read around it ---------
    K.reset()
    t0 = time.perf_counter()
    runner = StageRunner(cfg, params, attn_impl="kernel", device="cuda")
    mgr = PipelineManager(runner, split=splits[0], net=NetworkModel(20.0),
                          sample_inputs=prompt, checkpoint_path=ckpt)
    first = serve()
    check(tuple(first.shape) == (1, PROMPT, cfg.vocab_size)
          and bool(torch.isfinite(first).all()),
          f"first request: logits {tuple(first.shape)}, finite "
          f"{bool(torch.isfinite(first).all())}")
    mgr.set_network(NetworkModel(5.0))
    diffs, reps = {}, []
    for strategy, split in zip(("switch_b2", "switch_a", "pause_resume"),
                               splits[1:]):
        if strategy == "switch_a":
            mgr.build_standby(split)
        reps.append(mgr.repartition(strategy, split))
        # switch_a rebuilds the old split's standby in the background, and
        # its warm-up launches the kernels too: let it land first
        mgr.drain()
        diffs[strategy] = max_diff(serve(), first)
    launches = K.read()
    wall = time.perf_counter() - t0
    rep_b2, rep_a, rep_pr = reps
    for rep in reps:
        print(f"[stateless] {rep.strategy}: split {rep.old_split} -> "
              f"{rep.new_split}, downtime {rep.downtime:.6f} s "
              f"(build {rep.t_build:.6f} s); max |logit diff| from the "
              f"first request {diffs[rep.strategy]:.3e}")
    check(rep_pr.downtime > rep_b2.downtime > rep_a.downtime,
          "downtime ordering pause_resume > switch_b2 > switch_a violated")
    # the same kernels run in the same order whatever the split
    check(all(d == 0.0 for d in diffs.values()),
          f"logits changed across switches: {diffs}")
    for name, n in per_request.items():
        check(launches[name] >= 4 * n, f"{name} launched {launches[name]} "
                                       f"times over 4 requests")
    attn_flops = 0
    if cfg.num_heads:
        q = torch.empty((1, PROMPT, cfg.num_heads, cfg.head_dim),
                        device="meta")
        k = torch.empty((1, PROMPT, cfg.num_kv_heads, cfg.head_dim),
                        device="meta")
        attn_flops = per_request["flash_attention"] \
            * FA.bound_flops(q, k, causal=True)
    bound = request_bound_ms(cfg, params, PROMPT, attn_flops)
    logits, prof = profile_step(lambda: mgr.serve(prompt)[0], bound,
                                device_kernels(cfg))
    check(torch.equal(logits, first), "profiled request's logits differ")
    shut(mgr)
    med = sorted(request_ms)[len(request_ms) // 2]
    print(f"[stateless] launches {launches} ({per_request} a request); "
          f"request wall (edge + cloud, unscaled) median {med:.3f} ms of "
          f"{request_ms}; profiled request: {prof}")
    return {"launches": launches, "launches_per_request": per_request,
            "wall_s": wall, "request_ms": request_ms,
            "request_ms_median": med, "profiled_request": prof,
            "downtime_s": {r.strategy: r.downtime for r in reps},
            "build_s": {r.strategy: r.t_build for r in reps},
            "logit_diff_from_first": diffs}


# ---------------------------------------------------------------------------
# one model through phases 4-6
# ---------------------------------------------------------------------------

# (arch, layer splits 1/2 -> 1/4 -> 1/2 -> 3/4 of the depth); zamba2's
# 20 -> 40 and 40 -> 60 moves carry shared-attention applications across
MODELS = ("qwen2.5-3b", "falcon-mamba-7b", "zamba2-7b")


def run_model(K, arch, seed, gclog: GcLog) -> dict:
    """Full-width ``arch`` in bf16 (random weights from a generator seeded
    with ``seed``) through the stateful decode path, both hand-off arms
    and the stateless path; frees the weights and the checkpoint after."""
    import shutil
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.core.network import NetworkModel
    from repro_torch.core.stages import param_bytes
    from repro_torch.models.transformer import init_model

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(arch)
    L = cfg.num_layers
    splits = [L // 2, L // 4, L // 2, (3 * L) // 4]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = init_model(cfg, gen, dtype=torch.bfloat16, device="cuda")
    need = param_bytes(params) + 2 ** 30
    free = shutil.disk_usage(tempfile.gettempdir()).free
    # pause_resume writes the whole model as a checkpoint there
    check(free >= need, f"{tempfile.gettempdir()} has {free} B free; "
                        f"pause_resume's checkpoint of {arch} needs {need}")
    kw = dict(net=NetworkModel(20.0), prompt_len=PROMPT, max_seq=MAX_SEQ,
              seed=seed, decode_impl="auto", attn_impl="kernel",
              device="cuda")
    ckpt = None
    try:
        gclog.label = f"{arch} phase 4"
        sl, tokens, ref_logits, ckpt = phase_slice(K, cfg, params, kw,
                                                   splits, gclog)
        sl["checkpoint_bytes"] = os.path.getsize(ckpt)
        free_memory()
        gclog.label = f"{arch} phase 5"
        sl["handoff_checks"] = phase_handoff(K, cfg, params, kw, tokens,
                                             ref_logits, splits)
        del ref_logits
        free_memory()
        gclog.label = f"{arch} phase 6"
        st = phase_stateless(K, cfg, params, ckpt, seed, splits)
    finally:
        if ckpt is not None:
            os.remove(ckpt)
    del params
    peak = torch.cuda.max_memory_allocated()
    free_memory()
    # the startup-heap freeze (core/heap.py) must pin nothing of a model
    left = torch.cuda.memory_allocated()
    check(left <= 2 ** 30, f"{arch} left {left} B on the card after its "
          f"phases")
    wall = time.perf_counter() - t0
    print(f"[{arch}] phases 4-6 took {wall:.1f} s; checkpoint "
          f"{sl['checkpoint_bytes']} B; peak device memory {peak} B; "
          f"left after freeing {left} B")
    return {"arch": arch, "num_layers": L, "splits": splits,
            "wall_s": wall, "peak_device_bytes": peak,
            "left_device_bytes": left, "stateful": sl, "stateless": st}


def free_memory() -> None:
    """Return what the last phase's objects held to the card: collect
    their reference cycles, then empty PyTorch's cache."""
    gc.collect()
    torch.cuda.empty_cache()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    t_start = time.perf_counter()

    # phase 1: device
    if not torch.cuda.is_available():
        fail("no CUDA device")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    try:
        from repro_torch.kernels import build
        from repro_torch.kernels import flash_attention as FA
        from repro_torch.kernels import flash_decode as FD
        from repro_torch.kernels import mamba_scan as MS
        from repro_torch.kernels import ssd_scan as SD
    except ImportError as e:
        fail(f"the port is not beside this script: {e}")
    check("jax" not in sys.modules, "the port imported jax")
    # the plain versions are the oracles: f32 products in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    max_clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader",
         "-i", "0"], capture_output=True, text=True, timeout=60)
    print(f"[device] {smi}; max SM clock {max_clock.stdout.strip()}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")

    # phase 2: build
    t_build = build.build(force=True)
    print(f"[build] {build.library_path().name} built in {t_build:.2f} s; "
          f"flash_decode_kernel<type, rows> registers and spill bytes: "
          f"{decode_registers(build.library_path().parent / 'nvcc.log')}")

    # phase 3: kernels
    gclog = GcLog()
    gclog.label = "phase 3"
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    rows = {"flash_decode_attention": phase_kernel(FD, gen),
            "flash_attention": phase_prefill_kernel(FA, gen),
            "mamba1_scan": phase_mamba_kernel(MS, gen),
            "ssd_scan": phase_ssd_kernel(SD, gen)}
    K = Counts({"flash_decode_attention": FD.flash_decode_attention,
                "flash_attention": FA.flash_attention,
                "mamba1_scan": MS.mamba1_scan, "ssd_scan": SD.ssd_scan})

    # phases 4-6: each model's stateful and stateless paths
    models = [run_model(K, arch, args.seed, gclog) for arch in MODELS]
    for name, row in rows.items():
        by_path = {}
        for m in models:
            for path in ("stateful", "stateless"):
                n = m[path]["launches"][name]
                if n:
                    by_path[f"{m['arch']} {path}"] = n
        row["launches"] = sum(by_path.values())
        row["launches_by_path"] = by_path
        check(row["launches"] > 0, f"{name} never launched on a main path")
    check("jax" not in sys.modules, "the port imported jax")

    # phase 7: report
    wall = time.perf_counter() - t_start
    print(f"[done] the whole script took {wall:.1f} s; garbage "
          f"collections {gclog.summary()}")
    print(json.dumps({"kernels": list(rows.values()), "build_s": t_build,
                      "wall_s": wall, "models": models}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
