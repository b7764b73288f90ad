"""End-to-end smoke of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails:

1. device    — a CUDA device is present; prints nvidia-smi's name and power
               limit line.
2. build     — builds the hand-written kernels from ``src/repro_torch/csrc``
               (one nvcc per source, all started together).
3. kernel    — holds each kernel against its plain PyTorch version on the
               card.  flash_decode: the reference test grid, the full-width
               decode shape, per-row pos with a dead row, size-1 pos vector
               == scalar.  flash_attention: the reference shape grid and
               mask cases in f32 and bf16, sequence-major views of
               heads-major K/V (strides, no copies), and the two full-width
               prefill shapes (1024 and 2048 tokens, causal, bf16).  Times
               kernel, plain version and one PyTorch library call at the
               full-width shapes, beside the least time the card could take
               (the larger of bytes over its data-sheet memory rate and
               operations over its data-sheet bf16 rate).
4. slice     — serves full-width qwen2.5-3b (all 36 layers) in bf16 (random
               weights from a seeded generator) through the edge-cloud
               decode pipeline with the prefill and the recompute arm on
               the flash-attention kernel, repartitions live under
               switch_b2, switch_a and pause_resume, checks the decode
               kernel ran in every attention layer of every decode step,
               the prefill kernel in every layer of the prefill and of
               every moved layer of a recompute hand-off, the paper's
               downtime ordering, finite logits, and that an unswitched
               session fed the same tokens gives the same logits.
5. handoff   — both hand-off arms on the card: a switch pinned to the
               transfer arm must leave the logits bit-equal to the
               unswitched session's; after a switch pinned to the recompute
               arm, the moved layers' KV is held against the KV the decode
               steps wrote and the logits against the unswitched session's,
               and planted faults (stale and lost KV in the moved layers)
               are read the same way and must fail the KV limit.
6. stateless — the quickstart path at full width: one 1024-token prompt
               served through the stateless edge-cloud pipeline
               (``StageRunner`` on the flash-attention kernel), then
               repartitioned under switch_b2, switch_a and pause_resume
               with a request after each; checks one prefill-kernel launch
               per layer of every request, the downtime ordering, and
               logits bit-equal to the first request's after every switch.
7. report    — prints the ``kernels`` JSON line, the card's nvidia-smi line,
               and as the last line ``{"ok": true, "device": {...}}``.

Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
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
# (end to end, 5% of the largest logit) and the moved layers' KV (5% of
# the largest |KV|; the recompute's prefill-shaped matmuls round otherwise
# than the decode steps', by under 1% on the card)
LOGIT_RTOL = 5e-2
KV_RTOL = 5e-2


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
FULL_POS = (1, 17, 1024, 2048)
TIMED_POS = 1024                                 # the served context length


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

    # timing at the full-width shape, bf16, with the served context length;
    # caches rotate over > 50 MB of copies, so every launch finds its cache
    # out of L2 as a decode step does (36 layers' caches + 6 GB of weights
    # stream through L2 between two visits of one layer)
    B, H, KH, S, D = (FULL[x] for x in ("B", "H", "KH", "S", "D"))
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

    # the library call computes the same function: hold it to the kernel
    ref = FD.flash_decode_attention(qs[0], ks[0], vs[0], pos=pos_t)
    lib_err = max_diff(library(0).transpose(1, 2), ref)
    lib_tol = LIB_RTOL * ref.float().abs().max().item()
    check(lib_err <= lib_tol, f"library yardstick disagrees: {lib_err} > "
                              f"{lib_tol}")
    iters = 200
    # plain, kernel, kernel, plain: compare the two within one call
    plain1 = cuda_ms(lambda i: FD.flash_decode_attention_plain(
        qs[i % n], ks[i % n], vs[i % n], pos=pos_t), iters)
    kern1 = cuda_ms(lambda i: FD.flash_decode_attention(
        qs[i % n], ks[i % n], vs[i % n], pos=pos_t), iters)
    kern2 = cuda_ms(lambda i: FD.flash_decode_attention(
        qs[i % n], ks[i % n], vs[i % n], pos=pos_t), iters)
    plain2 = cuda_ms(lambda i: FD.flash_decode_attention_plain(
        qs[i % n], ks[i % n], vs[i % n], pos=pos_t), iters)
    lib_ms = cuda_ms(library, iters)
    nbytes = FD.bound_bytes(qs[0], ks[0], TIMED_POS)
    flops = 4 * B * H * TIMED_POS * D
    from repro_torch.core.hardware import H100
    t_bytes = nbytes / H100.hbm_bw * 1e3
    t_ops = flops / H100.flops * 1e3            # bf16 on the tensor cores
    row = {"name": "flash_decode_attention", "route": "cuda",
           "source": "src/repro_torch/csrc/flash_decode.cu",
           "replaces": "src/repro/kernels/flash_decode.py:94",
           "launches": None, "max_abs_err": max(errs.values()),
           "max_abs_err_by_dtype": errs,
           "ms": min(kern1, kern2), "kernel_ms": min(kern1, kern2),
           "plain_ms": min(plain1, plain2), "library_ms": lib_ms,
           "library_max_abs_err": lib_err,
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "timed_shape": {"B": B, "H": H, "KH": KH, "S": S, "D": D,
                           "pos": TIMED_POS, "dtype": "bfloat16"},
           "timed_runs_ms": {"kernel": [kern1, kern2],
                             "plain": [plain1, plain2]}}
    print(f"[kernel] full-width bf16 pos={TIMED_POS}: kernel "
          f"{row['ms']:.5f} ms, plain {row['plain_ms']:.5f} ms, library "
          f"{lib_ms:.5f} ms (max abs err {lib_err:.3e}), bound "
          f"{row['bound_ms']:.6f} ms ({row['bound_by']})")
    return row


# tests/test_kernels.py's flash-attention shape grid (non-causal) and mask
# cases; the full-width prefill shapes of qwen2.5-3b: the served prompt and
# the recompute arm's max_seq
FA_SHAPES = [(1, 16, 16, 2, 2, 16), (2, 64, 64, 4, 2, 32),
             (1, 40, 40, 4, 4, 16), (2, 32, 32, 8, 1, 64),
             (1, 33, 65, 2, 2, 8)]
FA_MASKS = [(True, None, 0), (True, 48, 0), (False, 24, 0), (True, None, 7)]
FA_FULL = dict(B=1, H=16, KH=2, D=128)
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
    B, H, KH, D = (FA_FULL[x] for x in ("B", "H", "KH", "D"))
    for S in FA_FULL_S:
        compare(*inputs(B, S, S, H, KH, D, torch.bfloat16),
                f"full width S={S}", causal=True)
    print(f"[kernel] flash_attention matches its plain version: max abs err "
          f"{errs}, bf16 at most {rel['bfloat16']:.3e} of max|plain| "
          f"(tolerances f32 {FP32_ATOL}, bf16 {BF16_RTOL} of max|plain|)")

    # timing at the full-width shapes, bf16, causal; inputs rotate over
    # > 128 MB of copies, so no launch finds its inputs in the 50 MB L2
    sdpa = torch.nn.functional.scaled_dot_product_attention
    timed = []
    for S in FA_FULL_S:
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
        timed.append({"S": S, "ms": min(kern1, kern2),
                      "plain_ms": min(plain1, plain2), "library_ms": lib_ms,
                      "library_max_abs_err": lib_err,
                      "bound_ms": max(t_bytes, t_ops),
                      "bound_by": "bytes" if t_bytes >= t_ops
                      else "operations",
                      "runs_ms": {"kernel": [kern1, kern2],
                                  "plain": [plain1, plain2]}})
        t = timed[-1]
        print(f"[kernel] flash_attention full-width bf16 causal S={S}: "
              f"kernel {t['ms']:.5f} ms, plain {t['plain_ms']:.5f} ms, "
              f"library {lib_ms:.5f} ms (max abs err {lib_err:.3e}), bound "
              f"{t['bound_ms']:.6f} ms ({t['bound_by']})")
        del sets
    first = timed[0]                # the served prompt's shape
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
            "by_seq": timed}


# ---------------------------------------------------------------------------
# phase 4: the slice
# ---------------------------------------------------------------------------

PROMPT, MAX_SEQ = 1024, 2048


def phase_slice(FD, FA, cfg, params, kw) -> tuple:
    from repro_torch.core.network import NetworkModel
    from repro_torch.core.stateful import make_stateful_manager

    L = cfg.num_layers
    splits = [L // 2, L // 4, L // 2, (3 * L) // 4]   # 18, 9, 18, 27
    # --- the main path, with the launch counts read around it ---------
    FD.flash_decode_attention.launches = 0
    FA.flash_attention.launches = 0
    sw = time.perf_counter()
    mgr, session = make_stateful_manager(cfg, params, split=splits[0], **kw)
    check(mgr.runner.resolved_decode_impl == "kernel",
          f"decode_impl auto resolved to {mgr.runner.resolved_decode_impl}")
    # DecodeSession.prefill runs the stack twice (the second run times the
    # host's recompute throughput, as the reference's does): one prefill-
    # kernel launch per layer each time, and no other full-sequence pass
    prefill = FA.flash_attention.launches
    check(prefill == 2 * L, f"the prefill launched the prefill kernel "
                            f"{prefill} times, want {2 * L} (2 x {L} layers)")
    print(f"[slice] {cfg.name}: {L} layers, d_model {cfg.d_model}, "
          f"{cfg.num_heads}/{cfg.num_kv_heads} heads, bf16, prompt "
          f"{PROMPT}, max_seq {MAX_SEQ}; set-up "
          f"{time.perf_counter() - sw:.2f} s")

    logits_seen = []
    step_ms = []            # edge + cloud wall of a step, unscaled
    per_step = []           # kernel launches counted in each checked step

    def serve(n: int, per_step_check: bool):
        edge_scale = mgr.active.edge_scale
        for _ in range(n):
            before = FD.flash_decode_attention.launches
            logits, timing = mgr.serve(None)
            step_ms.append((timing.t_edge / edge_scale + timing.t_cloud)
                           * 1e3)
            if per_step_check:
                got = FD.flash_decode_attention.launches - before
                check(got == L, f"decode step launched the kernel {got} "
                                f"times, want {L} (one per layer)")
                per_step.append(got)
            logits_seen.append(logits.float().cpu())

    recompute = []          # prefill-kernel launches of each switch

    def repartition(strategy, split):
        before = FA.flash_attention.launches
        rep = mgr.repartition(strategy, split)
        got = FA.flash_attention.launches - before
        moved = abs(rep.new_split - rep.old_split)
        want = moved if rep.handoff_mode == "recompute" else 0
        check(got == want, f"{strategy} {rep.old_split} -> {rep.new_split} "
                           f"({rep.handoff_mode}) launched the prefill "
                           f"kernel {got} times, want {want}")
        recompute.append(got)
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
    launches = FD.flash_decode_attention.launches
    fa_launches = FA.flash_attention.launches
    wall = time.perf_counter() - t0
    check(launches >= 40 * L, f"kernel launched {launches} times over 40 "
                              f"decode steps of {L} layers")
    check(fa_launches == prefill + sum(recompute),
          f"prefill kernel launched {fa_launches} times, want {prefill} + "
          f"{recompute}")
    for rep in (rep_b2, rep_a, rep_pr):
        print(f"[slice] {rep.strategy}: split {rep.old_split} -> "
              f"{rep.new_split}, downtime {rep.downtime:.6f} s, hand-off "
              f"{rep.handoff_mode} ({rep.t_handoff:.6f} s, "
              f"{rep.handoff_bytes} B)")
    print(f"[slice] prefill kernel: {prefill} launches in the prefill, "
          f"{recompute} in the three switches' hand-offs")
    check(rep_pr.downtime > rep_b2.downtime > rep_a.downtime,
          "downtime ordering pause_resume > switch_b2 > switch_a violated")
    check(all(bool(torch.isfinite(x).all()) for x in logits_seen),
          "non-finite logits")
    ckpt = mgr.pool.checkpoint_path       # phase 6 reloads it too
    tokens = session.tokens.clone()
    mgr.close()

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
                                        request_bound_ms(params, 1),
                                        ("decode_split_kernel",
                                         "decode_combine_kernel"))
        else:
            logits, _ = ref.serve(feed)
        ref_logits.append(logits.float().cpu())
        diffs.append(max_diff(ref_logits[-1], logits_seen[i]))
    ref.close()
    scale = max(x.abs().max().item() for x in logits_seen)
    pre = max(diffs[:16])
    post = max(diffs[16:])
    print(f"[slice] unswitched session: max |logit diff| before the first "
          f"switch {pre:.3e}, after {post:.3e} (max |logit| {scale:.3e})")
    # before any switch both streams run the same kernels on the same
    # inputs: bit-exact.  The recompute arm re-prefills the moved layers'
    # KV with prefill-shaped matmuls whose bf16 rounding differs from the
    # decode steps', so after it the logits agree to bf16 precision only
    # (phase 5 holds the recomputed KV itself to a limit that planted
    # faults fail).
    check(pre == 0.0, f"logits differ before any switch: {pre}")
    check(post <= LOGIT_RTOL * scale, f"logits after switches differ by "
                                      f"{post} (> {LOGIT_RTOL} of {scale})")
    med = sorted(step_ms[:16])[8]
    print(f"[slice] decode step (edge + cloud wall, split {splits[0]}): "
          f"median {med:.3f} ms over the first 16 steps; profiled step: "
          f"{prof}")
    check(len(set(per_step)) == 1, f"launches per step vary: {per_step}")
    out = {"launches": launches, "launches_per_step": per_step[0],
           "prefill_kernel_launches": fa_launches,
           "prefill_kernel_launches_in_prefill": prefill,
           "prefill_kernel_launches_per_switch": recompute,
           "wall_s": wall, "step_ms_median_first16": med, "step_ms": step_ms,
           "profiled_step": prof,
           "downtime_s": {"switch_b2": rep_b2.downtime,
                          "switch_a": rep_a.downtime,
                          "pause_resume": rep_pr.downtime},
           "handoff": {"switch_b2": rep_b2.handoff_mode,
                       "switch_a": rep_a.handoff_mode,
                       "pause_resume": rep_pr.handoff_mode},
           "logit_diff": {"before_switch": pre, "after_switch": post,
                          "max_abs_logit": scale}}
    return out, tokens, ref_logits, ckpt


def request_bound_ms(params, tokens: int, attn_flops: int = 0) -> float:
    """Least time the card could take for one request of ``tokens`` tokens:
    the larger of every weight read once from device memory and the
    matrix products' operations (2 a weight a token, the tied embedding as
    the LM head; ``attn_flops`` for the attention) at the bf16 peak."""
    from repro_torch.core.hardware import H100
    from repro_torch.core.stages import tree_leaves
    weights = tree_leaves(params)
    nbytes = sum(t.numel() * t.element_size() for t in weights)
    # the stacked layer matrices and the (tied) head; norm scales are 1-D
    matmul = sum(t.numel() for t in tree_leaves(params["layers"])
                 if t.dim() == 3) + params["embed"].numel()
    flops = 2 * tokens * matmul + attn_flops
    return max(nbytes / H100.hbm_bw, flops / H100.flops) * 1e3


def profile_step(call, bound_ms, kernel_keys):
    """One request (``call()`` returns its logits) under torch.profiler:
    device busy time (the sum of the kernels' and copies' own device time,
    counted once each), idle share of the request's wall, the device time
    and share of the kernels whose names contain one of ``kernel_keys``,
    and busy time over the request's bound ``bound_ms``
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
    kern = sum(e.self_device_time_total for e in events
               if any(name in e.key for name in kernel_keys))
    bound_us = bound_ms * 1e3
    top = sorted(events, key=lambda e: e.self_device_time_total,
                 reverse=True)[:6]
    return logits, {
        "wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
        "idle_share": max(0.0, 1.0 - busy / wall_us) if wall_us else None,
        "kernel_device_ms": kern / 1e3,
        "kernel_share_of_busy": kern / busy if busy else None,
        "bound_ms": bound_ms,
        "busy_over_bound": busy / bound_us,
        "top_device_ms": {e.key[:60]: e.self_device_time_total / 1e3
                          for e in top}}


# ---------------------------------------------------------------------------
# phase 5: both hand-off arms, and planted faults
# ---------------------------------------------------------------------------

def phase_handoff(FA, cfg, params, kw, tokens, ref_logits) -> dict:
    """Replays the main path's tokens through a third session: 16 steps at
    split 18, a switch_b2 to split 9 pinned to the transfer arm, 8 steps,
    then a switch_b2 back to 18 pinned to the recompute arm (moving layers
    9..18), read three ways from the same post-switch state: sound, with
    the moved layers' KV stale (rows of the served steps zeroed, as if the
    hand-off never ran) and lost (all rows zeroed).  Each is read as the
    moved layers' KV against the KV the decode steps wrote, and as the
    logits of the next 8 steps against the unswitched session's."""
    from repro_torch.core.stateful import make_stateful_manager
    L = cfg.num_layers
    mgr, s = make_stateful_manager(cfg, params, split=L // 2, **kw)
    scale = max(x.abs().max().item() for x in ref_logits)

    def serve(i0, n) -> float:
        worst = 0.0
        for i in range(i0, i0 + n):
            logits, _ = mgr.serve(
                {"token": tokens[:, PROMPT + i:PROMPT + 1 + i]})
            worst = max(worst, max_diff(logits.cpu(), ref_logits[i]))
        return worst

    check(serve(0, 16) == 0.0, "logits differ before any switch")
    mgr.pool.force_mode = "transfer"
    rep_t = mgr.repartition("switch_b2", L // 4)
    check(rep_t.handoff_mode == "transfer" and rep_t.handoff_bytes > 0,
          f"pinned transfer switch ran {rep_t.handoff_mode}, "
          f"{rep_t.handoff_bytes} B")
    d_transfer = serve(16, 8)
    print(f"[handoff] transfer arm: split {rep_t.old_split} -> "
          f"{rep_t.new_split}, {rep_t.handoff_bytes} B, wall "
          f"{rep_t.t_handoff:.6f} s; max |logit diff| {d_transfer:.3e}")
    # the payload carries the moved layers' KV bits unchanged
    check(d_transfer == 0.0, f"logits differ after a transfer hand-off: "
                             f"{d_transfer}")

    # the moved layers' KV as the decode steps wrote it: the state the
    # recompute arm must rebuild (both stages share one card)
    lo, hi = L // 4, L // 2
    truth = {k: t[:, :, :s.pos].clone() for k, t in s.subset(lo, hi).items()}
    mgr.pool.force_mode = "recompute"
    before = FA.flash_attention.launches
    rep_r = mgr.repartition("switch_b2", hi)
    check(rep_r.handoff_mode == "recompute",
          f"pinned recompute switch ran {rep_r.handoff_mode}")
    got = FA.flash_attention.launches - before
    check(got == hi - lo, f"the recompute hand-off launched the prefill "
                          f"kernel {got} times, want {hi - lo} (one per "
                          f"moved layer)")
    pos = s.pos
    kv_limit = KV_RTOL * max(t.float().abs().max().item()
                             for t in truth.values())
    logit_limit = LOGIT_RTOL * scale
    snap = s.snapshot()
    kv, logit = {}, {}
    for name, first_row in (("sound", None), ("stale", PROMPT),
                            ("lost", 0)):
        s.restore(snap)
        moved = s.subset(lo, hi)
        if first_row is not None:
            for t in moved.values():
                t[:, :, first_row:pos].zero_()
        kv[name] = max(max_diff(moved[k][:, :, :pos], truth[k])
                       for k in truth)
        logit[name] = serve(24, 8)
    mgr.close()
    print(f"[handoff] recompute arm: split {rep_r.old_split} -> "
          f"{rep_r.new_split}; max |diff| of the moved layers' KV from the "
          f"decode-written KV: sound {kv['sound']:.3e}, stale "
          f"{kv['stale']:.3e}, lost {kv['lost']:.3e} (limit "
          f"{kv_limit:.3e}); max |logit diff| over the next 8 steps: sound "
          f"{logit['sound']:.3e}, stale {logit['stale']:.3e}, lost "
          f"{logit['lost']:.3e} (limit {logit_limit:.3e})")
    check(kv["sound"] <= kv_limit, f"recomputed KV differs by {kv['sound']}"
                                   f" (> {kv_limit})")
    check(logit["sound"] <= logit_limit, f"logits after a recompute "
                                         f"hand-off differ by "
                                         f"{logit['sound']}")
    for fault in ("stale", "lost"):
        check(kv[fault] > kv_limit, f"the KV limit {kv_limit} does not "
                                    f"catch {fault} KV ({kv[fault]})")
    return {"transfer": {"bytes": rep_t.handoff_bytes,
                         "t_handoff_s": rep_t.t_handoff,
                         "max_abs_logit_diff": d_transfer},
            "recompute": {"prefill_kernel_launches": got,
                          "kv_max_abs_diff": kv, "kv_limit": kv_limit,
                          "max_abs_logit_diff": logit,
                          "logit_limit": logit_limit}}


# ---------------------------------------------------------------------------
# phase 6: the stateless quickstart path at full width
# ---------------------------------------------------------------------------

def phase_stateless(FA, cfg, params, ckpt, seed) -> dict:
    """One 1024-token prompt through the stateless edge-cloud pipeline at
    unit split 18 (embedding + 18 layers on the edge), then switch_b2 to 9,
    switch_a to 18 and pause_resume to 27 (reloading phase 4's
    checkpoint), with one request after each switch."""
    from repro_torch.core.network import NetworkModel
    from repro_torch.core.stages import StageRunner
    from repro_torch.core.switching import PipelineManager

    L = cfg.num_layers
    gen = torch.Generator().manual_seed(seed + 2)
    prompt = {"tokens": torch.randint(0, cfg.vocab_size, (1, PROMPT),
                                      generator=gen).cuda()}
    request_ms = []         # edge + cloud wall of a request, unscaled

    def serve():
        before = FA.flash_attention.launches
        logits, timing = mgr.serve(prompt)
        torch.cuda.synchronize()
        got = FA.flash_attention.launches - before
        check(got == L, f"a request launched the prefill kernel {got} "
                        f"times, want {L} (one per layer)")
        request_ms.append((timing.t_edge / mgr.active.edge_scale
                           + timing.t_cloud) * 1e3)
        return logits

    # --- the main path, with the launch count read around it ----------
    FA.flash_attention.launches = 0
    t0 = time.perf_counter()
    runner = StageRunner(cfg, params, attn_impl="kernel", device="cuda")
    mgr = PipelineManager(runner, split=L // 2, net=NetworkModel(20.0),
                          sample_inputs=prompt, checkpoint_path=ckpt)
    first = serve()
    check(tuple(first.shape) == (1, PROMPT, cfg.vocab_size)
          and bool(torch.isfinite(first).all()),
          f"first request: logits {tuple(first.shape)}, finite "
          f"{bool(torch.isfinite(first).all())}")
    mgr.set_network(NetworkModel(5.0))
    diffs, reps = {}, []
    for strategy, split in (("switch_b2", L // 4), ("switch_a", L // 2),
                            ("pause_resume", (3 * L) // 4)):
        if strategy == "switch_a":
            mgr.build_standby(split)
        reps.append(mgr.repartition(strategy, split))
        # switch_a rebuilds the old split's standby in the background, and
        # its warm-up launches the kernel too: let it land first
        mgr.drain()
        diffs[strategy] = max_diff(serve(), first)
    launches = FA.flash_attention.launches
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
    check(launches >= 4 * L, f"prefill kernel launched {launches} times "
                             f"over 4 requests of {L} layers")
    q = torch.empty((1, PROMPT, cfg.num_heads, cfg.head_dim), device="meta")
    k = torch.empty((1, PROMPT, cfg.num_kv_heads, cfg.head_dim),
                    device="meta")
    bound = request_bound_ms(params, PROMPT,
                             L * FA.bound_flops(q, k, causal=True))
    logits, prof = profile_step(lambda: mgr.serve(prompt)[0], bound,
                                ("flash_attention_kernel",))
    check(torch.equal(logits, first), "profiled request's logits differ")
    mgr.close()
    med = sorted(request_ms)[len(request_ms) // 2]
    print(f"[stateless] {launches} prefill-kernel launches ({L} a "
          f"request); request wall (edge + cloud, unscaled) median "
          f"{med:.3f} ms of {request_ms}; profiled request: {prof}")
    return {"launches": launches, "launches_per_request": L,
            "wall_s": wall, "request_ms": request_ms,
            "request_ms_median": med, "profiled_request": prof,
            "downtime_s": {r.strategy: r.downtime for r in reps},
            "build_s": {r.strategy: r.t_build for r in reps},
            "logit_diff_from_first": diffs}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    # phase 1: device
    if not torch.cuda.is_available():
        fail("no CUDA device")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    try:
        from repro_torch.kernels import build
        from repro_torch.kernels import flash_attention as FA
        from repro_torch.kernels import flash_decode as FD
    except ImportError as e:
        fail(f"the port is not beside this script: {e}")
    check("jax" not in sys.modules, "the port imported jax")
    # the plain versions are the oracles: f32 products in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    print(f"[device] {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")

    # phase 2: build
    t_build = build.build(force=True)
    print(f"[build] {build.library_path().name} built in {t_build:.2f} s")

    # phase 3: kernel
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    row = phase_kernel(FD, gen)
    fa_row = phase_prefill_kernel(FA, gen)

    # phase 4: slice
    from repro_torch.configs import get_config
    from repro_torch.core.network import NetworkModel
    from repro_torch.models.transformer import init_model
    cfg = get_config("qwen2.5-3b")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    params = init_model(cfg, gen, dtype=torch.bfloat16, device="cuda")
    kw = dict(net=NetworkModel(20.0), prompt_len=PROMPT, max_seq=MAX_SEQ,
              seed=args.seed, decode_impl="auto", attn_impl="kernel",
              device="cuda")
    ckpt = None
    try:
        sl, tokens, ref_logits, ckpt = phase_slice(FD, FA, cfg, params, kw)
        row["launches"] = sl["launches"]
        row["launches_per_step"] = sl["launches_per_step"]

        # phase 5: hand-off arms
        sl["handoff_checks"] = phase_handoff(FA, cfg, params, kw, tokens,
                                             ref_logits)
        del ref_logits
        torch.cuda.empty_cache()

        # phase 6: the stateless quickstart path
        st = phase_stateless(FA, cfg, params, ckpt, args.seed)
    finally:
        if ckpt is not None:
            os.remove(ckpt)
    fa_row["launches"] = sl["prefill_kernel_launches"] + st["launches"]
    fa_row["launches_by_path"] = {
        "stateful_decode": sl["prefill_kernel_launches"],
        "stateless_quickstart": st["launches"]}
    fa_row["launches_per_request"] = st["launches_per_request"]
    fa_row["launches_per_prefill"] = sl["prefill_kernel_launches_in_prefill"]
    fa_row["launches_per_switch"] = sl["prefill_kernel_launches_per_switch"]
    check("jax" not in sys.modules, "the port imported jax")

    # phase 7: report
    print(json.dumps({"kernels": [row, fa_row], "build_s": t_build,
                      "slice": sl, "stateless": st}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
