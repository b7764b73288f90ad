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
               decode shapes (qwen2.5-3b's, zamba2-7b's D 112,
               qwen2-moe-a2.7b's 16 KV heads, mixtral-8x22b's 4096-row
               ring of phase 9, 48 heads over 8, internvl2-76b's 64 over
               8, whisper-medium's 16 over 16 of D 64 at pos 1 ... 448),
               per-row
               pos with a dead row (also at phase 7's slot-pool shape,
               B 4 at full width, its device time a call printed beside
               B 1's), size-1 pos vector == scalar.
               flash_attention: the reference shape grid and mask cases in
               f32 and bf16, D 112, sequence-major views of heads-major K/V
               (strides, no copies), the full-width prefill shapes of
               qwen2.5-3b, zamba2-7b and qwen2-moe-a2.7b (1024 and 2048
               tokens, causal, bf16) and internvl2-76b (64 heads over 8)
               and their recompute-shaped call (q_offset 1024, 300
               queries), mixtral-8x22b's windowed prefill (6144 tokens,
               window 4096), and whisper-medium's three attentions at D
               64 in f32 and bf16: its encoder (1500 x 1500, non-causal,
               a last key tile of 28 keys), its cross attention (448
               queries against 1500 keys) and its decoder (448, causal).
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
               falcon-mamba-7b (64 mamba1 layers), zamba2-7b (81 mamba2
               layers, 13 shared-attention applications),
               qwen2-moe-a2.7b (12 of its 24 layers, cut for memory: 60
               routed experts top-4 and 4 shared, capacity factor 1.25)
               and internvl2-76b (6 of its 80 layers, cut for memory;
               its stateful prompt is text only, as the reference serves
               it), in bf16 with
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
               switch_a runs with the build worker held and must make no
               fresh ``cudaMalloc`` (its hand-off draws the blocks the
               standby's warm-up left in the session's arena; the
               worker's re-armed standby build, which allocates its
               weights, starts after the block).
5. handoff   — both hand-off arms on the card: a switch pinned to the
               transfer arm must leave the logits bit-equal to the
               unswitched session's; after a switch pinned to the recompute
               arm, the moved layers' state (KV, conv, SSM) is held against
               the state the decode steps wrote and the logits against the
               unswitched session's, and planted faults (the moved layers'
               state stale by 8 steps, and lost) are read the same way and
               must fail the limit (on the SSM state where there is one).
               An MoE's recompute routes max_seq rows with another expert
               capacity than the prefill and the decode steps did, so its
               state is held against the plain route's recompute of the
               same prefix (chunked attention in place of the kernel), its
               distance to the decode-written state printed.
6. stateless — one 1024-row prompt served through the stateless
               edge-cloud pipeline (``StageRunner``; internvl2-76b's
               carries 256 seeded patch embeddings before 768 tokens, and
               then runs the standalone ``transformer.prefill`` of the same
               rows and 16 ``decode_step``s, every logit row held to
               ``forward_hidden`` over the longer sequence within 5% of
               the largest logit), then repartitioned
               under switch_b2, switch_a and pause_resume with a request
               after each; checks each kernel's launches per request, the
               downtime ordering, and logits bit-equal to the first
               request's after every switch.  pause_resume reloads phase
               4's checkpoint of the whole model from ``$TMPDIR`` (6.2 GB
               for qwen2.5-3b, ~14.5 GB for falcon-mamba-7b, ~13.5 GB for
               zamba2-7b; its free space is checked first), deleted after
               the model's phases.
7. serving   — qwen2.5-3b only, before its checkpoint is deleted: a
               4-slot pool (``make_session_manager``) behind the
               ``ServingEngine`` on a ``VirtualClock`` (1 Gbps link, one
               decode step a second, sessions of 1024, 384 and 64 prompt
               tokens and one of 256 admitted mid-stream).  7a: three
               scripted switches 1/2 -> 1/4 -> 1/2 -> 1/4 of the depth
               under switch_b2, switch_a and pause_resume (reloading phase
               4's checkpoint), handing off on the plan's arm, and once
               more under switch_b2 and switch_a pinned to the transfer
               arm (switch_b2 over switch_a, and by at least twice the
               spread of the exports' copies into page-locked memory net
               of each switch's two host CRC32 passes, the export's and
               the import's, which both strategies run over the same
               bytes; the raw margin and the export walls' spread printed
               beside); checks the measured stream downtime
               order, switch drops,
               each step's and admission's launches, and every live
               slot's logits
               against a twin pool that never switched, fed the same
               admissions and tokens (bit-equal until the first hand-off
               and after transfers, 5% after a re-prefill).  7b: a
               ``NeukonfigController`` on a 20 -> 5 -> 20 Mbps trace with
               every transfer payload corrupted in transit: a
               repartition, its fallback to recompute, the logits after.
               Prints each stream's downtime, drops, p50/p99, admission
               walls and a probe a switch.
8. cnn       — the paper's own CNNs, VGG19 (25 units, 143.7 M params)
               and MobileNetV2 (12 units, 3.5 M) at the published 224 px,
               batch 1, f32, random weights from a seeded generator, one
               after the other (no kernel of the port lies on this path:
               convolutions and pools are cuDNN's, and the phase checks
               that none of the four kernels launched): every split's
               edge-then-cloud logits bit-equal to the monolithic
               forward; ``profile_cnn`` on the card and Eq. 1's optimum at
               20 and 5 Mbps under the reference's default specs and
               under ``edge=EDGE_SPEC, cloud=H100``; then
               examples/serve_pipeline_torch.py's loop (4 fps, 20 -> 5 ->
               20 Mbps over 24 s of virtual time) under switch_b2,
               switch_a and pause_resume (reloading a checkpoint written
               to ``$TMPDIR`` and deleted after), a ``NeukonfigController``
               on the first pricing whose optimum moves, else switches
               scripted between the optimum and its neighbour.  Checks at
               least two switches a stream, the measured downtime order
               pause_resume > switch_b2 > switch_a, no switch drops under
               switch_a, ``crosscheck_timeline`` within 2 frames for full
               outages, and every frame's logits bit-equal to an
               unswitched pipeline's; prints each stream's downtime,
               drops, p50/p99 and memory over the initial (Table I)
               beside the paper's CPU-testbed downtimes.  Each stream
               draws its weight copies from two copies' worth of memory
               the allocator holds before it (``reserve_cache``): a
               standby's ``cudaMalloc`` on the build worker stalled the
               serving thread's forwards.
9. window    — mixtral-8x22b at full width (d_model 6144, 48 heads of 128
               over 8 KV heads, 8 experts of 16384 top-2, window 4096),
               2 of its 56 layers (cut for memory), bf16, routed without
               drops, through the standalone ``transformer.prefill`` and
               ``decode_step``: a 6144-token prompt on the flash-attention
               kernel into a 4096-row ring (max_seq 8192), then 16 decode
               steps on the flash-decode kernel; checks each kernel's
               launches (2 a prefill, 2 a step) and every logit row against
               the plain path and against the windowed full forward over
               the same tokens.
10. whisper  — whisper-medium at full depth (24 encoder and 24 decoder
               layers, d_model 1024, 16 heads of 64), bf16, seeded
               weights and frames: phase 6 with 448 tokens beside 1500
               frames (the encoder in unit 0, its output riding every
               boundary), splits 1/2 -> 1/4 -> 1/2 -> 3/4 of the decoder
               depth, 72 flash_attention launches a request (24 encoder,
               24 self, 24 cross); then the standalone ``prefill`` of 432
               tokens with the frames and 16 ``decode_step``s, 24
               flash_decode launches each (the cross attention is the
               plain ``decode_attention``, as the reference's), every
               logit row held to ``forward_hidden`` over the 448 tokens
               within 5% of the largest logit; prints the request's and
               the step's wall and busy time, the device time of the
               step's plain cross attention, and the peak memory; then
               phase 12's stateless part for it (its cloud stage on the
               mesh).
11. training — (a) the chunked flash attention's backward
               (``attention(impl="chunked")``) against autograd through
               ``naive_attention`` at qwen2.5-3b's training shape (B 1, S
               2048, 16/2 heads of 128) and mixtral-8x22b's window (S
               6144, window 4096, 48/8 heads of 128), f32, causal; (b)
               ``chunked_cross_entropy``'s gradients against autograd
               through the whole (1, 2048, 151936) f32 logits; each to
               1e-4 of its largest value; (c) ``training.train`` on
               qwen2.5-3b at full width and depth (36 layers), f32 weights
               and AdamW state, 20 steps of 1 x 2048 tokens at lr 3e-4,
               ``remat``, the last step under torch.profiler; (d) the
               same initialisation and optimizer on the stream's first
               batch repeated 5 times (``make_train_step``).  Checks
               finite losses, the first within 1.5 nats above ln V, the
               repeated batch's loss reaching 0.5 nats below its first
               (the stream's
               own cannot fall in 20 steps at this vocabulary, in either
               package: each batch is a fresh range of tokens) and no
               launch of the four kernels (none has a backward); prints
               the first loss against ln V, the median
               step wall, tokens/s, model FLOP/s (6 N T) as a share of
               the FP32 peak, the peak memory and the profiled step's
               busy time, idle share and top device operations.
12. sharding — the cloud stage on a 2-way tensor-parallel mesh
               (``repro_torch.distributed.tp``), full width, bf16, after
               each model's phases 4-6 while its weights are loaded:
               qwen2.5-3b (full depth, after its phase 7), falcon-mamba-7b
               (channel-parallel Mamba-1), zamba2-7b (head-parallel
               Mamba-2 and the shared block), qwen2-moe-a2.7b
               (expert-parallel), the three cut for memory to
               ``SHARD_DEPTH`` (printed), and inside phase 10
               whisper-medium (stateless only: its decoder's self and
               cross attention by heads).  One shard a card where there
               are two cards, else both on ``cuda:0``
               (``set_mesh_devices``; the mapping is printed).  (a) the
               family's kernels at one shard's shapes (its attention
               heads: flash_decode at pos 64 / 1024 / 2048 where the
               stateful path runs, flash_attention at the prefill's or
               whisper's calls; mamba1_scan over half the channels,
               ssd_scan over half the heads, at S 1 and 1024) against
               their plain versions in f32 and bf16, and their times; (b)
               a request through the stateless pipeline on one device,
               then switch_b2 onto the mesh at the same split, switch_a
               to another split on it and switch_b2 back: logits within
               5% of the largest of the first request's (an MoE's: on
               the tokens the mesh routed as one device did, the
               re-routed ones counted; and in f32, its first two layers
               all on the mesh, every token routed alike and the logits
               within 1e-4 of the largest), two requests on
               the mesh bit-equal, each mesh transition on its
               ``SwitchReport`` and ``ReshardReport`` moving no weight
               bytes (built pipelines placed theirs at build), the
               launches of each request (the cloud range's scaled by tp)
               and its all-reduces (2 an attention + MLP or MoE layer or
               a Mamba layer, 3 a whisper decoder layer); (c) the
               stateful pipeline (prompt 1024, max_seq 2048): 8 steps,
               switch_b2 onto the mesh at the same split, 8 steps, back,
               8 steps, each step's logits within 5% of an unswitched
               session's fed the same tokens (an MoE's re-routed steps
               counted), each transition moving
               exactly the live cloud-range state (KV, conv and SSM
               state), each step's launches and all-reduces; (d) prints
               the request's and the step's wall and busy time on the
               mesh beside one device's, the all-reduces and their device
               time, peak memory, ``BuildReport.t_reshard`` and
               ``calibrate_mesh``'s scales beside the mapping (with both
               shards on one card they are fitted to walls with no link
               in them: not a tensor-parallel speed); (e) for qwen2.5-3b,
               a 4-slot pool on the same weights (phase 7's prompts,
               max_seq 2048; 12a holds flash_decode at a shard's 8/1
               heads with its per-row positions [1024, 0, 2047, 37]) with
               8 steps between each of: switch_b2 onto the mesh, an
               admission into the free slot, one into the full pool
               (preempts and parks), switch_b2 to 3/4 of the depth on
               the transfer arm, back and there again on the recompute
               arm, the readmission (preempts), switch_b2 off the mesh;
               every live session's logits within 5% of the largest of
               an unswitched twin pool's fed the same admissions and
               tokens, 0 state bytes moved at each mesh transition, the
               first step on the mesh placing exactly the live
               cloud-range state (printed), each step's launches
               (flash_decode: the edge layers plus 2 x the cloud layers
               on the mesh) and all-reduces (2 a cloud layer).
13. counter  — (a) ``repro_torch.launch.dryrun``'s count of qwen2.5-3b's
               train_4k, prefill_32k and decode_32k steps on the 16 x 16
               production mesh, on meta tensors in this process, priced on
               the H100 spec: prints each pair's compute, memory and
               collective terms.  (b) after qwen2.5-3b's phases 4-7, with
               its weights loaded: ``distributed.op_analysis``'s counter
               around its full-width decode step and its 1024-token
               stateless request on the kernel route; checks the counter
               saw exactly as many calls of each kernel as its launch
               counter rose by, the counted bytes at least the weights'
               and the counted flops positive; prints the counted flops
               and bytes against ``model_flops_estimate``, the counted
               bound beside the hand-computed one, and the roofline
               shares of the profiled busy time and the unprofiled wall.
14. report   — prints the script's wall, the ``kernels`` JSON line, the
               card's nvidia-smi line, and as the last line
               ``{"ok": true, "device": {...}}``.

Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
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
# an MoE (qwen2-moe-a2.7b, capacity factor 1.25): a recompute routes the
# moved layers' max_seq rows with another expert capacity than the
# prefill (PROMPT rows) and the decode steps (1 row) did, and top-k routing
# is discontinuous, so a few tokens change experts and their rows of the
# deeper layers' state move by tens of percent.  Its recomputed state is
# held against the plain route's recompute of the same prefix (chunked
# attention in place of the kernel: the same routing semantics, bf16
# rounding apart) to MOE_STATE_RTOL of each kind's largest |value|, which
# the planted stale and lost states still exceed; the logits after a
# recompute against the unswitched session's, to MOE_LOGIT_RTOL of the
# largest logit (phases 4 and 5).  PERF.md gives the distances measured
# before these limits were set.
MOE_STATE_RTOL = 2e-1
MOE_LOGIT_RTOL = 1e-1


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
# phase 7's slot pool: 4 slots of qwen2.5-3b, per-row pos, a dead row
SLOTS = dict(B=4, H=16, KH=2, S=2048, D=128)
SLOT_POS = [1024, 0, 2047, 37]
ZFULL = dict(B=1, H=32, KH=32, S=2048, D=112)    # zamba2-7b's shared attn
MFULL = dict(B=1, H=16, KH=16, S=2048, D=128)    # qwen2-moe-a2.7b (MHA)
# mixtral-8x22b's 4096-row ring (phase 9): 48 heads over 8 KV heads
XFULL = dict(B=1, H=48, KH=8, S=4096, D=128)
VFULL = dict(B=1, H=64, KH=8, S=2048, D=128)     # internvl2-76b (GQA 8)
# whisper-medium's decoder self attention (phase 10): 16 heads of 64, no
# GQA, a cache of its 448-token context
WFULL = dict(B=1, H=16, KH=16, S=448, D=64)
FULL_POS = (1, 17, 1024, 2048)
RING_POS = (1, 2049, 4096)
WHISPER_POS = (1, 17, 200, 448)
TIMED_POS = 1024                                 # the served context length
DEVICE_POS = (64, 1024, 2048)                    # device time a call read at
DECODE_KERNEL = "flash_decode_kernel"            # its name in the profiler
# decode_device_us's traces this run, and those that held no record of the
# kernel and were taken again (printed at the end)
DECODE_TRACES = {"traces": 0, "taken_again": 0}


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
            for full in (FULL, ZFULL, MFULL, VFULL):
                compare(full["B"], full["H"], full["KH"], full["S"],
                        full["D"], pos, dtype)
        for pos in WHISPER_POS:
            compare(WFULL["B"], WFULL["H"], WFULL["KH"], WFULL["S"],
                    WFULL["D"], pos, dtype)
        for pos in RING_POS:
            compare(XFULL["B"], XFULL["H"], XFULL["KH"], XFULL["S"],
                    XFULL["D"], pos, dtype)
        # per-row pos with a dead row: exact zeros there
        rows = [40, 1, 0, 64]
        _, _, _, out = compare(4, 4, 2, 64, 16, rows, dtype)
        check(bool((out[2] == 0).all()), f"pos==0 row not zero ({dtype})")
        # the same at the slot pool's full-width shape (phase 7)
        _, _, _, out = compare(SLOTS["B"], SLOTS["H"], SLOTS["KH"],
                               SLOTS["S"], SLOTS["D"], SLOT_POS, dtype)
        dead = SLOT_POS.index(0)
        check(bool((out[dead] == 0).all()),
              f"slot pool shape: the dead row is not zero ({dtype})")
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

    timed = [time_decode(FD, rand, **full)
             for full in (FULL, ZFULL, MFULL, XFULL, VFULL)]
    timed.append(time_decode(FD, rand, **WFULL, pos=WFULL["S"],
                             device_pos=(1, WFULL["S"])))
    first = timed[0]                # qwen2.5-3b's decode shape
    slots_us = slot_device_us(FD, rand)
    print(f"[kernel] flash_decode at the slot pool's shape {SLOTS}, bf16, "
          f"pos {SLOT_POS}: {slots_us:.2f} us of device time a call, beside "
          f"{first['device_us_per_call'][TIMED_POS]:.2f} us at B 1, pos "
          f"{TIMED_POS}")
    row = {"name": "flash_decode_attention", "route": "cuda",
           "source": "src/repro_torch/csrc/flash_decode.cu",
           "replaces": "src/repro/kernels/flash_decode.py:94",
           "launches": None, "max_abs_err": max(errs.values()),
           "max_abs_err_by_dtype": errs,
           "ms": first["ms"], "kernel_ms": first["ms"],
           "device_us_per_call": first["device_us_per_call"],
           "host_us_per_call": first["host_us_per_call"],
           "device_us_per_call_slot_pool": {"shape": SLOTS,
                                            "pos": SLOT_POS,
                                            "us": slots_us},
           "plain_ms": first["plain_ms"], "library_ms": first["library_ms"],
           "library_max_abs_err": first["library_max_abs_err"],
           "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
           "timed_shape": first["shape"],
           "timed_runs_ms": first["runs_ms"], "by_shape": timed}
    return row


def slot_device_us(FD, rand) -> float:
    """The kernel's device microseconds a call at the slot pool's shape
    (``SLOTS``, bf16, per-row ``SLOT_POS``), caches rotated out of L2."""
    B, H, KH, S, D = (SLOTS[k] for k in ("B", "H", "KH", "S", "D"))
    per_call = 2 * B * KH * S * D * 2
    n = max(2, -(-128 * 2 ** 20 // per_call))
    dtype = torch.bfloat16
    qs = [rand((B, 1, H, D), dtype) for _ in range(n)]
    ks = [rand((B, KH, S, D), dtype) for _ in range(n)]
    vs = [rand((B, KH, S, D), dtype) for _ in range(n)]
    return decode_device_us(FD, qs, ks, vs, SLOT_POS)


def decode_device_us(FD, qs, ks, vs, pos, reps: int = 40) -> dict:
    """The flash-decode kernel's device microseconds a call at ``pos`` (a
    scalar, or one a row) (torch.profiler over ``reps`` calls on the
    rotating caches ``qs``, ``ks``, ``vs``), checked to be at most one
    launch of ``DECODE_KERNEL`` a call and no other device work.  The
    trace can lose a kernel's records (PERF.md: one of 40, and once all
    40), so the mean is over the records it holds, and a trace that holds
    none is taken again, three times at most (printed); the calls are the
    same each time and change nothing."""
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
    attempts = 3
    for attempt in range(1, attempts + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(reps):
                call(i)
            torch.cuda.synchronize()
        DECODE_TRACES["traces"] += 1
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total > 0]
        kern = [e for e in events if DECODE_KERNEL in e.key]
        launches = sum(e.count for e in kern)
        other = [e.key[:60] for e in events if DECODE_KERNEL not in e.key]
        if launches or other:
            break
        DECODE_TRACES["taken_again"] += 1
        print(f"[kernel] flash_decode at pos {pos}: trace {attempt} of "
              f"{attempts} holds no record of {reps} calls; taken again")
    check(0 < launches <= reps and not other,
          f"flash_decode at pos {pos}: {launches} {DECODE_KERNEL} launches "
          f"in {reps} calls, other device work {other}")
    return sum(e.self_device_time_total for e in kern) / launches


def time_decode(FD, rand, B, H, KH, S, D, pos: int = TIMED_POS,
                device_pos: tuple = DEVICE_POS) -> dict:
    """Kernel, plain version and one library call at a full-width decode
    shape, bf16, at ``pos`` live rows (the served context length), beside
    the bound; the kernel's device time a call at ``device_pos``
    (torch.profiler) and the wrapper's host time a call.  Caches rotate
    over > 128 MB of copies, so every launch finds its cache out of L2 as
    a decode step does (a step streams every layer's weights and caches
    through L2 between two visits of one layer)."""
    from repro_torch.core.hardware import H100
    dtype = torch.bfloat16
    per_call = 2 * B * KH * S * D * 2
    n = max(2, -(-128 * 2 ** 20 // per_call))
    qs = [rand((B, 1, H, D), dtype) for _ in range(n)]
    ks = [rand((B, KH, S, D), dtype) for _ in range(n)]
    vs = [rand((B, KH, S, D), dtype) for _ in range(n)]
    pos_t = torch.tensor(pos, dtype=torch.int32, device="cuda")
    mask = (torch.arange(S, device="cuda") < pos)[None, None, None, :]
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
    device_us = {p: decode_device_us(FD, qs, ks, vs, p) for p in device_pos}
    nbytes = FD.bound_bytes(qs[0], ks[0], pos)
    flops = 4 * B * H * min(pos, S) * D
    t_bytes = nbytes / H100.hbm_bw * 1e3
    t_ops = flops / H100.flops * 1e3            # bf16 on the tensor cores
    out = {"shape": {"B": B, "H": H, "KH": KH, "S": S, "D": D,
                     "pos": pos, "dtype": "bfloat16"},
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
FA_MFULL = dict(B=1, H=16, KH=16, D=128)        # qwen2-moe-a2.7b (MHA)
FA_VFULL = dict(B=1, H=64, KH=8, D=128)         # internvl2-76b (GQA 8)
FA_FULL_S = (1024, 2048)
# whisper-medium (phase 10), 16 heads of 64, no GQA: (Sq, Sk, causal) of
# its encoder over 1500 frames (the last key tile 28 of 64 keys), its
# decoder's cross attention (448 queries against the 1500 frames) and
# its decoder's self attention
FA_WFULL = dict(B=1, H=16, KH=16, D=64)
FA_WSHAPES = ((1500, 1500, False), (448, 1500, False), (448, 448, True))
# mixtral-8x22b's windowed prefill (phase 9): 6144 tokens, window 4096
FA_XFULL = dict(B=1, H=48, KH=8, D=128, S=6144, window=4096)


def time_attention(FA, inputs, full, Sq, Sk, causal) -> dict:
    """Kernel, plain version and one library call at a full-width
    attention shape (``full``: B, H, KH, D and a window), bf16, beside the
    bound; ``inputs(B, Sq, Sk, H, KH, D, dtype)`` makes one set.  Inputs
    rotate over > 128 MB of copies, so no launch finds them in the 50 MB
    L2."""
    from repro_torch.core.hardware import H100
    sdpa = torch.nn.functional.scaled_dot_product_attention
    B, H, KH, D = (full[x] for x in ("B", "H", "KH", "D"))
    S = Sq
    W = full.get("window")
    per_call = 2 * B * (Sq * H + Sk * KH) * D
    n = max(2, -(-128 * 2 ** 20 // per_call))
    sets = [inputs(B, Sq, Sk, H, KH, D, torch.bfloat16) for _ in range(n)]
    # a window takes the library call an explicit mask: the band
    ar = torch.arange(S, device="cuda")
    band = None if W is None else \
        (ar[None, :] <= ar[:, None]) & (ar[None, :] > ar[:, None] - W)

    def kernel(i):
        return FA.flash_attention(*sets[i % n], causal=causal, window=W)

    def plain(i):
        return FA.flash_attention_plain(*sets[i % n], causal=causal,
                                        window=W)

    def library(i):
        q, k, v = (t.transpose(1, 2) for t in sets[i % n])
        if band is None:
            return sdpa(q, k, v, is_causal=causal, enable_gqa=True)
        return sdpa(q, k, v, attn_mask=band, enable_gqa=True)

    # the library call computes the same function: hold it to the kernel
    ref = kernel(0)
    lib_err = max_diff(library(0).transpose(1, 2), ref)
    lib_tol = LIB_RTOL * ref.float().abs().max().item()
    check(lib_err <= lib_tol, f"library yardstick disagrees at Sq={Sq} "
                              f"Sk={Sk}: {lib_err} > {lib_tol}")
    iters = 20
    # plain, kernel, kernel, plain: compare the two within one call
    plain1 = cuda_ms(plain, iters)
    kern1 = cuda_ms(kernel, iters)
    kern2 = cuda_ms(kernel, iters)
    plain2 = cuda_ms(plain, iters)
    lib_ms = cuda_ms(library, iters)
    q, k, _ = sets[0]
    t_ops = FA.bound_flops(q, k, causal=causal, window=W) / H100.flops * 1e3
    t_bytes = FA.bound_bytes(q, k) / H100.hbm_bw * 1e3
    chain, mean = FA.schedule_chain(B, Sq, Sk, H, causal=causal, window=W,
                                    q_offset=0)
    t = {"S": S, "Sk": Sk, "causal": causal, "H": H, "KH": KH, "D": D,
         "window": W, "ms": min(kern1, kern2),
         "plain_ms": min(plain1, plain2), "library_ms": lib_ms,
         "library_max_abs_err": lib_err, "bound_ms": max(t_bytes, t_ops),
         "bound_by": "bytes" if t_bytes >= t_ops else "operations",
         "runs_ms": {"kernel": [kern1, kern2], "plain": [plain1, plain2]}}
    print(f"[kernel] flash_attention full-width bf16 causal={causal} "
          f"H={H} KH={KH} D={D} Sq={Sq} Sk={Sk} window={W}: "
          f"kernel {t['ms']:.5f} ms, plain {t['plain_ms']:.5f} ms, "
          f"library {lib_ms:.5f} ms (max abs err {lib_err:.3e}), bound "
          f"{t['bound_ms']:.6f} ms ({t['bound_by']}); schedule chain "
          f"{chain} key tiles, mean {mean:.2f} a consumer")
    return t


def phase_prefill_kernel(FA, gen) -> dict:
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
        # whisper-medium's three attentions at full width
        B, H, KH, D = (FA_WFULL[x] for x in ("B", "H", "KH", "D"))
        for Sq, Sk, causal in FA_WSHAPES:
            compare(*inputs(B, Sq, Sk, H, KH, D, dtype),
                    f"whisper H={H} KH={KH} D={D} Sq={Sq} Sk={Sk}",
                    causal=causal)
    for full in (FA_FULL, FA_ZFULL, FA_MFULL, FA_VFULL):
        B, H, KH, D = (full[x] for x in ("B", "H", "KH", "D"))
        for S in FA_FULL_S:
            compare(*inputs(B, S, S, H, KH, D, torch.bfloat16),
                    f"full width H={H} KH={KH} D={D} S={S}", causal=True)
        # the recompute arm: queries at 1024 ... 1323 against 1324 keys
        compare(*inputs(B, 300, 1324, H, KH, D, torch.bfloat16),
                f"recompute-shaped H={H} KH={KH} D={D}", causal=True,
                q_offset=1024)
    B, H, KH, D, S, W = (FA_XFULL[x] for x in ("B", "H", "KH", "D", "S",
                                               "window"))
    compare(*inputs(B, S, S, H, KH, D, torch.bfloat16),
            f"windowed full width H={H} KH={KH} D={D} S={S}", causal=True,
            window=W)
    # phase 7's slot pool: its batch re-prefill at (SERVE_SLOTS, MAX_SEQ)
    H, KH, D = (FA_FULL[x] for x in ("H", "KH", "D"))
    for dtype in (torch.float32, torch.bfloat16):
        compare(*inputs(SERVE_SLOTS, MAX_SEQ, MAX_SEQ, H, KH, D, dtype),
                f"slot-pool re-prefill B={SERVE_SLOTS} S={MAX_SEQ} H={H} "
                f"KH={KH} D={D}", causal=True)
    print(f"[kernel] flash_attention matches its plain version: max abs err "
          f"{errs}, bf16 at most {rel['bfloat16']:.3e} of max|plain| "
          f"(tolerances f32 {FP32_ATOL}, bf16 {BF16_RTOL} of max|plain|)")

    # timing at the full-width shapes, bf16
    timed = []
    shapes = [(full, S, S, True) for full in (FA_FULL, FA_ZFULL)
              for S in FA_FULL_S]
    shapes += [(FA_MFULL, FA_FULL_S[0], FA_FULL_S[0], True),
               (FA_XFULL, FA_XFULL["S"], FA_XFULL["S"], True),
               (FA_VFULL, FA_FULL_S[0], FA_FULL_S[0], True)]
    shapes += [(FA_WFULL,) + shape for shape in FA_WSHAPES]
    for full, Sq, Sk, causal in shapes:
        timed.append(time_attention(FA, inputs, full, Sq, Sk, causal))
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
    applications among them) and one scan kernel per mamba layer.
    Whisper's full pass from layer 0 also runs its encoder (one
    flash_attention a layer; in unit 0, with the edge) and each decoder
    layer's cross attention
    (another); its decode step's cross attention is the plain
    ``decode_attention``, as the reference's."""
    out = dict.fromkeys(K.wrappers, 0)
    if cfg.family == "audio":
        if mode == "decode":
            out["flash_decode_attention"] = hi - lo
        else:
            out["flash_attention"] = 2 * (hi - lo) + (
                cfg.encoder.num_layers if lo == 0 else 0)
        return out
    from repro_torch.core.stateful import unit_index_of_split, unit_list
    units = unit_list(cfg)[unit_index_of_split(cfg, lo):
                           unit_index_of_split(cfg, hi)]
    attn = sum(1 for kind, _ in units if kind == "app"
               or cfg.family in ("dense", "moe", "vlm"))
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


@contextlib.contextmanager
def builds_held(mgr):
    """Hold the pool's build worker for the span of the block: a build a
    switch submits (switch_a's re-armed successor and its hand-off
    warm-up) waits until the block ends, so the allocator counters read
    across the block are the switch's own thread's."""
    gate = threading.Event()
    held = mgr.pool.executor.submit(gate.wait)
    try:
        yield
    finally:
        gate.set()
        held.wait()


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
    with builds_held(mgr):
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
    # the standby's warm-up left the hand-off's blocks in the session's
    # arena and the re-armed build waited: no new device memory
    fresh = probes["switch_a"]["alloc"]["num_device_alloc"]
    check(fresh == 0, f"switch_a's repartition made {fresh} fresh "
                      f"cudaMalloc(s), want 0")
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
    if cfg.moe is not None:
        # the reference's (E, C, D) layout reads every expert a step
        prof["bound_all_experts_ms"] = request_bound_ms(cfg, params, 1,
                                                        all_experts=True)
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
    rtol = MOE_LOGIT_RTOL if cfg.moe else LOGIT_RTOL
    check(post <= rtol * scale, f"logits after switches differ by {post} "
                                f"(> {rtol} of {scale})")
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


def expert_weights(cfg, params) -> tuple:
    """``(elements, bytes)`` of the routed experts' stacked weights (0 for
    a model without an MoE)."""
    if cfg.moe is None:
        return 0, 0
    moe = params["layers"]["moe"]
    ws = [moe[k] for k in ("w_gate", "w_up", "w_down")]
    return (sum(w.numel() for w in ws),
            sum(w.numel() * w.element_size() for w in ws))


def request_bound_ms(cfg, params, tokens: int, extra_flops: int = 0,
                     all_experts: bool = False,
                     extra_bytes: int = 0) -> float:
    """Least time the card could take for one request of ``tokens`` tokens:
    the larger of every weight read once from device memory and the
    matrix products' operations (2 a weight a token: every layer matrix,
    the shared block's once per application, the LM head; plus
    ``extra_flops``, the attention's) at the bf16 peak.  An MoE's routed
    experts: a token's products use ``top_k`` of them, and the bytes count
    the experts the request can reach, ``min(E, tokens * top_k)`` of ``E``
    (``all_experts``: all of them, as the reference's dense layout reads
    them at any token count).  ``extra_bytes``: what else the request must
    read (a decode step's caches)."""
    from repro_torch.core.hardware import H100
    from repro_torch.core.stages import tree_leaves
    nbytes = sum(t.numel() * t.element_size()
                 for t in tree_leaves(params)) + extra_bytes
    exp_n, exp_bytes = expert_weights(cfg, params)
    if exp_n and not all_experts:
        E = cfg.moe.num_experts
        nbytes -= exp_bytes * (1 - min(E, tokens * cfg.moe.top_k) / E)
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
    if exp_n:
        matmul += exp_n * cfg.moe.top_k // cfg.moe.num_experts
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


def state_norm(moved: dict, truth: dict, pos: int) -> float:
    """``||moved - truth|| / ||truth||`` over every moved entry (KV live
    rows): a reading of the bulk, beside ``state_readings``' largest
    entry's."""
    from repro_torch.core.stateful import _is_kv
    num = den = 0.0
    for key, t in truth.items():
        got = moved[key][:, :, :pos] if _is_kv(key) else moved[key]
        num += (got.float() - t.float()).square().sum().item()
        den += t.float().square().sum().item()
    return (num / den) ** 0.5


def plain_recompute(cfg, params, snap, lo: int, hi: int, pos: int) -> dict:
    """The state of layers [lo, hi) as the plain route (chunked attention
    in place of the flash-attention kernel) recomputes it from the boundary
    activations of the session snapshot ``snap`` at live length ``pos``:
    the oracle of an MoE's recompute (KV sliced to ``pos``)."""
    from repro_torch.core.stateful import (StatefulStageRunner, _is_kv,
                                           unit_index_of_split)
    runner = StatefulStageRunner(cfg, params, max_seq=MAX_SEQ,
                                 attn_impl="chunked", device="cuda")
    u0 = unit_index_of_split(cfg, lo)
    x = snap["bounds"][u0].clone()
    x[:, pos:] = 0
    caches = runner.recompute_fn(u0, unit_index_of_split(cfg, hi))(
        runner.params, x, pos)
    return {k: (t[:, :, :pos] if _is_kv(k) else t).clone()
            for k, t in caches.items()}


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
    # an MoE's recompute routes its T = max_seq rows with another capacity
    # than the prefill (T = PROMPT) and the decode steps (T = 1) did, so
    # tokens that lost an expert there keep it here, and the reverse: its
    # state is held to the plain route's recompute of the same prefix
    plain = plain_recompute(cfg, params, snap, lo, hi, pos) if cfg.moe \
        else None
    readings, logit, vs_plain, l2 = {}, {}, {}, {}
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
        if plain is not None:
            vs_plain[name] = state_readings(moved, plain, pos)
            l2[name] = {"vs_plain": state_norm(moved, plain, pos),
                        "vs_decode_written": state_norm(moved, truth, pos)}
        logit[name] = serve(24, 8)
    shut(mgr)
    # the state whose faults must show: the SSM state where the family has
    # one, the KV of the attention layers otherwise
    primary = "ssm" if "ssm" in readings["sound"] else "kv"
    logit_limit = (MOE_LOGIT_RTOL if cfg.moe else LOGIT_RTOL) * scale
    print(f"[handoff] recompute arm: split {rep_r.old_split} -> "
          f"{rep_r.new_split}; launched {log[0]}; moved layers' state, max "
          f"|diff| over max |decode-written| by kind: {readings} (limit "
          f"{STATE_RTOL}{', not held: MoE' if plain else ''}); max |logit "
          f"diff| over the next 8 steps: {logit} (limit "
          f"{logit_limit:.3e})")
    held, limit = readings, STATE_RTOL
    if plain is not None:
        held, limit = vs_plain, MOE_STATE_RTOL
        print(f"[handoff] MoE: the moved layers' state against the plain "
              f"route's recompute of the same prefix, by kind: {vs_plain} "
              f"(limit {limit}); relative L2 norms of the difference {l2}")
    for kind, r in held["sound"].items():
        check(r <= limit, f"recomputed {kind} state differs by {r} of "
                          f"its max (> {limit})")
    check(logit["sound"] <= logit_limit, f"logits after a recompute "
                                         f"hand-off differ by "
                                         f"{logit['sound']}")
    for fault in ("stale", "lost"):
        r = held[fault][primary]
        check(r > limit, f"the {primary} limit {limit} does not catch "
                         f"{fault} state ({r})")
    return {"transfer": {"bytes": rep_t.handoff_bytes,
                         "t_handoff_s": rep_t.t_handoff,
                         "max_abs_logit_diff": d_transfer},
            "recompute": {"launches": log[0],
                          "state_rel_diff": readings,
                          "state_rel_diff_vs_plain_recompute": vs_plain,
                          "state_rel_l2": l2,
                          "state_limit": limit,
                          "max_abs_logit_diff": logit,
                          "logit_limit": logit_limit}}


# ---------------------------------------------------------------------------
# phase 6: the stateless path at full width
# ---------------------------------------------------------------------------

WHISPER_TOKENS = 448       # whisper's decoder context (its config)


def stateless_request(cfg, seed: int) -> dict:
    """Phase 6's request, made from ``seed``: ``PROMPT`` rows, of which
    internvl2's first ``frontend_tokens`` are seeded patch embeddings (256
    before 768 text tokens); for whisper ``WHISPER_TOKENS`` text tokens
    beside its encoder's ``context_len`` seeded frames.  The embeddings
    are bf16, the model's dtype (the encoder takes its dtype from the
    frames)."""
    gen = torch.Generator().manual_seed(seed)
    text = WHISPER_TOKENS if cfg.family == "audio" \
        else PROMPT - cfg.frontend_tokens
    out = {"tokens": torch.randint(0, cfg.vocab_size, (1, text),
                                   generator=gen)}
    if cfg.frontend == "vision":
        out["vision_embeds"] = torch.randn(
            (1, cfg.frontend_tokens, cfg.d_model), generator=gen)
    if cfg.frontend == "audio":
        out["frames"] = torch.randn(
            (1, cfg.encoder.context_len, cfg.d_model), generator=gen)
    return {k: (v.to(torch.bfloat16) if v.is_floating_point() else v).cuda()
            for k, v in out.items()}


def attention_flops(cfg, rows: int, n_self: int) -> int:
    """The attention's operations in one full pass over ``rows`` rows
    (``flash_attention.bound_flops``): ``n_self`` causal self attentions,
    and whisper's encoder over its frames and its cross attention against
    them, both non-causal."""
    from repro_torch.kernels import flash_attention as FA
    if not cfg.num_heads:
        return 0

    def flops(Sq, Sk, causal):
        q = torch.empty((1, Sq, cfg.num_heads, cfg.head_dim), device="meta")
        k = torch.empty((1, Sk, cfg.num_kv_heads, cfg.head_dim),
                        device="meta")
        return FA.bound_flops(q, k, causal=causal)
    out = n_self * flops(rows, rows, True)
    if cfg.family == "audio":
        T_enc = cfg.encoder.context_len
        out += cfg.encoder.num_layers * flops(T_enc, T_enc, False) \
            + cfg.num_layers * flops(rows, T_enc, False)
    return out


def frontend_flops(cfg, params, rows: int) -> int:
    """The products ``request_bound_ms`` does not count at ``rows`` rows:
    internvl2's ``vision_proj`` over its patches; whisper's encoder layers
    over its frames, and its cross-attention K/V projections over the
    frames rather than the text rows."""
    if cfg.frontend == "vision":
        return 2 * cfg.frontend_tokens * params["vision_proj"].numel()
    if cfg.frontend != "audio":
        return 0
    from repro_torch.core.stages import tree_leaves
    T_enc = cfg.encoder.context_len
    enc = sum(t.numel() for t in tree_leaves(params["encoder"]["layers"])
              if t.dim() == 3)
    xkv = sum(params["layers"]["xattn"][k].numel() for k in ("wk", "wv"))
    return 2 * T_enc * enc + 2 * (T_enc - rows) * xkv


def phase_stateless(K, cfg, params, ckpt, seed, splits) -> dict:
    """``stateless_request`` through the stateless edge-cloud pipeline at
    unit split ``splits[0]`` (embedding, the frontend and that many layers
    on the edge), then switch_b2, switch_a and pause_resume (reloading
    ``ckpt``, phase 4's checkpoint; without one the pool writes its own,
    deleted after) through ``splits[1:]``, with one request after each
    switch."""
    from repro_torch.core.network import NetworkModel
    from repro_torch.core.stages import StageRunner
    from repro_torch.core.switching import PipelineManager

    L = cfg.num_layers
    per_request = expected(K, cfg, 0, L, "full")
    prompt = stateless_request(cfg, seed + 2)
    rows = prompt["tokens"].shape[1] + cfg.frontend_tokens
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
    check(tuple(first.shape) == (1, rows, cfg.vocab_size)
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
    n_self = cfg.num_layers if cfg.family == "audio" \
        else per_request["flash_attention"]
    bound = request_bound_ms(cfg, params, rows,
                             attention_flops(cfg, rows, n_self)
                             + frontend_flops(cfg, params, rows))
    logits, prof = profile_step(lambda: mgr.serve(prompt)[0], bound,
                                device_kernels(cfg))
    check(torch.equal(logits, first), "profiled request's logits differ")
    shut(mgr)
    if ckpt is None:
        os.remove(mgr.checkpoint_path)
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


STANDALONE_STEPS = 16


def phase_standalone(K, cfg, params, prompt, extra, max_seq: int) -> dict:
    """The standalone ``transformer.prefill`` of ``prompt`` (its frontend
    inputs included) on the flash-attention kernel, then a
    ``decode_step`` on the flash-decode kernel for each token of
    ``extra`` (1, n); checks each kernel's launches (``expected``: a full
    pass a prefill, a decode pass a step), the cache's ``pos`` (the
    frontend's rows counted), and every logit row (the prefill's last,
    then each step's) against ``forward_hidden`` over the whole sequence
    (chunked attention), within ``LOGIT_RTOL`` of the largest logit.
    Prints the prefill's wall, the steps' median wall, a profiled step
    beside its bound (the weights a step reads, without the encoder and
    ``vision_proj``, and every cache row it reads once) and the logit
    distances."""
    from repro_torch.core.stages import param_bytes
    from repro_torch.models import transformer as T

    L, F, n = cfg.num_layers, cfg.frontend_tokens, extra.shape[1]
    P = prompt["tokens"].shape[1]
    per_prefill = expected(K, cfg, 0, L, "full")
    per_step = expected(K, cfg, 0, L, "decode")

    # --- the main path, with the launch counts read around it ---------
    K.reset()
    before = K.read()
    t = time.perf_counter()
    logits, cache = T.prefill(cfg, params, prompt, max_seq=max_seq,
                              attn_impl="kernel")
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t) * 1e3
    prefill_launches = K.since(before)
    got, steps = [logits], []
    for i in range(n):
        before = K.read()
        t = time.perf_counter()
        logits, cache = T.decode_step(cfg, params, extra[:, i:i + 1], cache,
                                      attn_impl="kernel")
        torch.cuda.synchronize()
        steps.append({"ms": (time.perf_counter() - t) * 1e3,
                      "launches": K.since(before)})
        got.append(logits)
    launches = K.read()
    got = torch.cat(got).float()
    check(prefill_launches == per_prefill,
          f"{cfg.name} standalone: the prefill launched {prefill_launches}, "
          f"want {per_prefill}")
    check(all(st["launches"] == per_step for st in steps),
          f"{cfg.name} standalone: decode steps launched "
          f"{[st['launches'] for st in steps]}, want {per_step}")
    check(int(cache["pos"]) == F + P + n,
          f"{cfg.name} standalone: pos {int(cache['pos'])}, want "
          f"{F + P + n}")
    check(bool(torch.isfinite(got).all()),
          f"{cfg.name} standalone: non-finite logits")
    step_ms = sorted(st["ms"] for st in steps)[n // 2]
    read = {k: v for k, v in params.items()
            if k not in ("encoder", "vision_proj")}
    def nbytes(t):
        return t.numel() * t.element_size()
    # whisper's cross K/V whole, the self-attention K/V's live rows
    cache_bytes = sum(nbytes(cache[k]) for k in ("ck", "cv") if k in cache) \
        + 2 * nbytes(cache["k"][:, :, :, :F + P + n])
    _, prof = profile_step(
        lambda: T.decode_step(cfg, params, extra[:, n - 1:n],
                              {k: (v.clone() if k != "pos" else v)
                               for k, v in cache.items()},
                              attn_impl="kernel")[0],
        request_bound_ms(cfg, read, 1, extra_bytes=cache_bytes),
        device_kernels(cfg))

    # --- the oracle: the full forward over the whole sequence ---------
    whole = dict(prompt, tokens=torch.cat([prompt["tokens"], extra], 1))
    h, _, _ = T.forward_hidden(cfg, params, whole, attn_impl="chunked")
    full = (h[0, F + P - 1:] @ T.lm_head_weights(cfg, params)).float()
    del h
    scale = full.abs().max().item()
    diffs = (got - full).abs().max(-1).values.tolist()
    limit = LOGIT_RTOL * scale
    print(f"[standalone] {cfg.name}: prefill of {F} + {P} rows "
          f"{prefill_ms:.1f} ms launched {prefill_launches}; {n} decode "
          f"steps (max_seq {max_seq}), median {step_ms:.3f} ms, each "
          f"launched {per_step}; max |logit diff| by row (prefill, then "
          f"each step) against the full forward {diffs} (limit "
          f"{limit:.3e} = {LOGIT_RTOL} of {scale:.3e}); profiled step "
          f"(weights {param_bytes(read)} B, caches {cache_bytes} B): "
          f"{prof}")
    check(max(diffs) <= limit, f"{cfg.name} standalone: logits differ from "
                               f"the full forward by {max(diffs)} "
                               f"(> {limit})")
    del cache
    return {"prompt_rows": F + P, "max_seq": max_seq, "launches": launches,
            "launches_per_prefill": prefill_launches,
            "launches_per_step": per_step, "prefill_ms": prefill_ms,
            "step_ms": [st["ms"] for st in steps], "step_ms_median": step_ms,
            "profiled_step": prof, "max_logit_diff_vs_full_forward": diffs,
            "logit_limit": limit}


# ---------------------------------------------------------------------------
# phase 7: the serving stream (qwen2.5-3b slot pool behind the engine)
# ---------------------------------------------------------------------------

SERVE_ARCH = "qwen2.5-3b"
SERVE_SLOTS = 4
SERVE_PROMPTS = (1024, 384, 64)     # admitted before the stream
SERVE_LATE = 256                    # admitted mid-stream
# 7a: one decode step a second of stream time; the mid-flight admission
# before the first switch; switches a quarter second after an arrival and
# 30 s apart, the stream 30 s past the last (pause_resume's reload of the
# whole model took 8-14 s a switch on the card, and 15.7-17.8 s on a
# slower host: steps must follow each of its outages)
SERVE_FPS, SERVE_S = 1.0, 96.0
SERVE_SWITCH_T = (5.25, 35.25, 65.25)
SERVE_ADMIT_T = 2.25
# the slot pool's link: 1 Gbps (the reference's slot-pool tests).  The
# plan prices a hand-off's transfer there above its re-prefill, so the
# strategies' streams hand off by recompute; a switch_b2 and a switch_a
# stream more pin the transfer arm
SERVE_MBPS = 1000.0
# 7b: examples/serve_pipeline.py:103's trace under a NeukonfigController
CTL_TRACE = [(0.0, 20.0), (8.0, 5.0), (16.0, 20.0)]
CTL_FPS, CTL_S = 2.0, 24.0
CTL_AFTER = 8                       # decode steps after the stream


def record_pool(K, sm, log: list, admits: list):
    """Log every admission (prompt, sid; launches and wall into
    ``admits``) and every committed decode step (its tokens and each live
    session's logits) of ``sm``, in order: what a twin pool replays."""
    admit, commit = sm.admit, sm.commit_step

    def rec_admit(prompt, sid=None):
        before = K.read()
        t0 = time.perf_counter()
        out = admit(prompt, sid=sid)
        admits.append({"sid": out, "tokens": int(len(prompt)),
                       "wall_s": time.perf_counter() - t0,
                       "launches": K.since(before)})
        log.append(("admit", prompt, out))
        return out

    def rec_commit(token, new_state, bounds, logits):
        commit(token, new_state, bounds, logits)
        log.append(("step", token.clone(),
                    {sid: sm.logits_for(sid) for sid in sm.session_ids()}))
    sm.admit, sm.commit_step = rec_admit, rec_commit


@contextlib.contextmanager
def serving_switch_probe(mgr, sm, gclog: GcLog, probes: list):
    """``switch_probe`` around one of the engine's switches, plus the
    transfer arm's two halves (``export_layers`` and ``import_layers``
    walls, ``host_counters`` across each) and, inside each half, its
    CRC32 pass (``payload_checksum``: the export's envelope, the import's
    validation) and the export's copies from the card into its
    page-locked ``HostBuffer``s (``_payload_entry``), appended to
    ``probes``."""
    from repro_torch.serving import sessions as SM
    parts, inside = {}, []

    def timed(name, fn):
        def run(*args, **kwargs):
            inside.append(name)
            part = parts[name] = {"copy_s": 0.0, "crc_s": 0.0}
            c0, t0 = host_counters(), time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                inside.pop()
                part.update(wall_s=time.perf_counter() - t0,
                            host=host_delta(c0, host_counters()))
        return run

    def tally(key, fn):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                if inside:
                    parts[inside[-1]][key] += time.perf_counter() - t0
        return run
    real = SM.payload_checksum, SM._payload_entry
    sm.export_layers = timed("export", sm.export_layers)
    sm.import_layers = timed("import", sm.import_layers)
    SM.payload_checksum = tally("crc_s", SM.payload_checksum)
    SM._payload_entry = tally("copy_s", SM._payload_entry)
    try:
        with switch_probe(mgr, sm, gclog) as rec:
            yield rec
        rec["handoff_parts"] = parts
        probes.append(rec)
    finally:
        del sm.export_layers, sm.import_layers
        SM.payload_checksum, SM._payload_entry = real


def log_switches(eng, mgr, sm, gclog: GcLog, log: list, probes: list):
    """Read every switch the engine runs with ``serving_switch_probe`` and
    mark it in the pool's ``log`` (a controller's switches too: they go
    through ``eng.execute_switch``)."""
    real = eng.execute_switch

    def logged(strategy, new_split):
        with serving_switch_probe(mgr, sm, gclog, probes):
            rep = real(strategy, new_split)
        log.append(("switch", rep.strategy))
        return rep
    eng.execute_switch = logged


def replay(pool, split: int, log: list) -> list:
    """Feed a fresh, never-switched pool the logged admissions and decode
    steps (the logged tokens); returns, per logged step, the largest
    |logit diff| over the sessions live at it (None at a switch)."""
    mgr, sm = pool(split)
    diffs = []
    for ev in log:
        if ev[0] == "admit":
            sm.admit(ev[1], sid=ev[2])
        elif ev[0] == "step":
            mgr.active.process({"token": ev[1]})
            diffs.append(max(max_diff(sm.logits_for(sid), want)
                             for sid, want in ev[2].items()))
        else:
            diffs.append(None)
    shut(mgr)
    return diffs


def phase_serving(K, cfg, params, ckpt, seed, gclog: GcLog) -> dict:
    """qwen2.5-3b at full width behind the ``ServingEngine`` on a
    ``VirtualClock``, a 4-slot pool (``make_session_manager``, max_seq
    ``MAX_SEQ``, every prefill and the admission on the kernels).

    7a: for each of switch_b2, switch_a and pause_resume (reloading phase
    4's checkpoint) on a fresh pool: 3 ragged sessions admitted, a stream
    of decode steps with a fourth admitted mid-stream and 3 scripted
    switches 1/2 -> 1/4 -> 1/2 -> 1/4 of the depth, every hand-off on the
    plan's arm (the masked recompute at ``SERVE_MBPS``); then switch_b2
    and switch_a again with every hand-off pinned to the transfer arm.
    Checks the plan's-arm streams' measured downtime order and switch
    drops, every kernel's launches a step and an admission, and each
    stream's logits against a twin pool that was never switched, fed the
    same admissions and tokens: bit-equal before the first hand-off (the
    mid-flight admission among those steps) and after every transfer
    hand-off, within ``LOGIT_RTOL`` of the largest logit after a
    re-prefill.  The transfer streams' downtimes are ordered, switch_b2's
    over switch_a's, and by at least twice the spread of the exports'
    copies into page-locked memory once each switch's host CRC32 passes
    are taken out (ROADMAP Queue C item 1); the raw margin and the export
    walls' spread are printed beside.

    7b: the same pool under switch_b2 driven by a ``NeukonfigController``
    on ``CTL_TRACE`` with every transfer payload corrupted in transit
    (``handoff_corrupt(p=1.0)``): at least one repartition, each falling
    back to the masked recompute, and the logits after it within
    ``LOGIT_RTOL`` of the largest logit of the twin's."""
    import warnings

    from repro_torch.core.controller import NeukonfigController
    from repro_torch.core.faults import faults
    from repro_torch.core.network import BandwidthTrace, NetworkModel
    from repro_torch.core.profiler import profile_transformer
    from repro_torch.core.stateful import (HandoffIntegrityWarning,
                                           StatefulEdgeCloudPipeline)
    from repro_torch.serving import (ServingEngine, VirtualClock,
                                     make_session_manager, request_stream)

    L = cfg.num_layers
    per_step = expected(K, cfg, 0, L, "decode")
    per_admit = expected(K, cfg, 0, L, "full")
    gen = torch.Generator().manual_seed(seed + 3)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=gen)
               for n in SERVE_PROMPTS + (SERVE_LATE,)]

    def pool(split, **kw):
        return make_session_manager(
            cfg, params, split=split, net=kw.pop("net", NetworkModel(20.0)),
            num_slots=SERVE_SLOTS, max_seq=MAX_SEQ, attn_impl="kernel",
            decode_impl="auto", device="cuda", checkpoint_path=ckpt,
            warm_standbys=True, **kw)

    def main_path(strategy, split, **kw):
        """A fresh pool with the logs attached, its build worker running
        (a deployment that has served before has one: started on the
        stream, the thread's start would land in switch_a's first swap),
        and the 3 sessions admitted."""
        mgr, sm = pool(split, **kw)
        mgr.pool.executor.submit(lambda: None).wait()
        log, admits = [], []
        record_pool(K, sm, log, admits)
        for i, p in enumerate(prompts[:3]):
            sm.admit(p, sid=f"s{i}")
        return mgr, sm, log, admits

    def check_launches(name, steps, admits, exact=True):
        """Each decode step's and admission's launches.  Under switch_a
        (``exact=False``) the old split's standby rebuilds on the build
        worker while the stream runs, and its warm-up steps launch the
        kernels too: each reading must then hold at least its own."""
        def holds(got, want):
            return got == want if exact else all(
                got[k] >= n for k, n in want.items())
        check(all(holds(s, per_step) for s in steps),
              f"{name}: a decode step launched {steps}, want {per_step}")
        want = [scaled(per_admit, 2)] + [per_admit] * (len(admits) - 1)
        got = [a["launches"] for a in admits]
        check(all(holds(g, w) for g, w in zip(got, want)),
              f"{name}: the admissions launched {got}, want {want} (the "
              f"first also times the host)")

    def stream_row(tl, admits, launches, diffs, wall):
        summ = tl.summary()
        return {"downtime_s": tl.downtime(),
                "switch_drops": tl.switch_drops(wake=1.0),
                "arrived": summ["arrived"], "dropped": summ["dropped"],
                "p50_ms": summ["p50_ms"], "p99_ms": summ["p99_ms"],
                "windows": [[w.t_start, w.t_end, w.old_split, w.new_split,
                             w.handoff_mode, w.t_handoff]
                            for w in tl.windows],
                "admissions": [{k: a[k] for k in ("sid", "tokens",
                                                  "wall_s")}
                               for a in admits],
                "launches": launches, "max_logit_diff_by_step": diffs,
                "wall_s": wall}

    out = {"launches": dict.fromkeys(K.wrappers, 0)}

    def add(launches):
        for name, n in launches.items():
            out["launches"][name] += n

    # --- 7a: the three strategies on the measured stream -----------------
    splits = [L // 4, L // 2, L // 4]

    def stream(strategy, arm):
        """One strategy's measured stream on a fresh pool: hand-offs on
        the plan's arm (``arm`` None) or pinned; the logged admissions and
        steps replayed on a twin pool that never switches."""
        name = f"7a {strategy}" + (f" ({arm} arm)" if arm else "")
        gclog.label = f"{SERVE_ARCH} phase {name}"
        K.reset()
        t0 = time.perf_counter()
        steps, recomputes, probes = [], [], []
        with counted(K, StatefulEdgeCloudPipeline, "process", steps):
            mgr, sm, log, admits = main_path(
                strategy, L // 2, net=NetworkModel(SERVE_MBPS),
                force_mode=arm)
            if strategy == "switch_a":
                # built for the live sessions: it warms the hand-off's
                # re-prefill too (StatefulPipelinePool.build_standby)
                mgr.build_standby(splits[0])
            eng = ServingEngine(mgr, clock=VirtualClock())
            eng.schedule_admit(SERVE_ADMIT_T, prompts[3], sid="late")
            for t, split in zip(SERVE_SWITCH_T, splits):
                eng.schedule_switch(t, strategy, split)
            log_switches(eng, mgr, sm, gclog, log, probes)
            with counted(K, sm, "recompute_layers", recomputes):
                tl = eng.run(request_stream({}, fps=SERVE_FPS,
                                            duration=SERVE_S))
                mgr.drain()
        launches = K.read()
        wall = time.perf_counter() - t0
        add(launches)
        # under switch_a the old split's standby rebuilds on the build
        # worker while the stream runs (its warm-up step and re-prefill
        # launch the kernels too)
        exact = strategy != "switch_a"
        check_launches(name, steps, admits, exact=exact)
        hand = mgr.pool.handoffs
        want = [expected(K, cfg, min(a, b), max(a, b), "full")
                for a, b, h in zip([L // 2] + splits, splits, hand)
                if h.mode == "recompute"]
        check(len(hand) == 3 and not any(h.fallback for h in hand)
              and (arm is None or all(h.mode == arm for h in hand))
              and (recomputes == want if exact else len(recomputes)
                   == len(want)),
              f"{name}: hand-offs {[(h.mode, h.fallback) for h in hand]}, "
              f"re-prefills launched {recomputes}, want {want}")
        check(sm.session_ids() == ["s0", "s1", "s2", "late"],
              f"{name}: live sessions {sm.session_ids()}")
        check(all(bool(torch.isfinite(sm.logits_for(sid)).all())
                  for sid in sm.session_ids()),
              f"{name}: non-finite logits")
        shut(mgr)
        diffs = replay(pool, L // 2, log)
        scale = max(x.abs().max().item() for ev in log if ev[0] == "step"
                    for x in ev[2].values())
        row = stream_row(tl, admits, launches, diffs, wall)
        row.update({"handoff_mode": [h.mode for h in hand],
                    "handoff_wall_s": [h.t_wall for h in hand],
                    "handoff_network_s": [h.t_network for h in hand],
                    "handoff_bytes": [h.moved_bytes for h in hand],
                    "switch_probes": probes})
        steps_seen = [x for x in diffs if x is not None]
        print(f"[serving] {name}: measured downtime "
              f"{row['downtime_s']:.6f} s over {len(tl.windows)} switches "
              f"(hand-offs {row['handoff_mode']}, walls "
              f"{row['handoff_wall_s']} s, priced link "
              f"{row['handoff_network_s']} s, {row['handoff_bytes']} B); "
              f"switch drops {row['switch_drops']}, dropped "
              f"{row['dropped']} of {row['arrived']}; p50 {row['p50_ms']} "
              f"ms, p99 {row['p99_ms']} ms; admission walls "
              f"{[round(a['wall_s'], 6) for a in admits]} s for "
              f"{[a['tokens'] for a in admits]} tokens; twin |logit diff| "
              f"by step {diffs} (None at a switch; max |logit| {scale:.3e});"
              f" {wall:.1f} s")
        for pr in probes:
            print(f"[serving] {name} probe: {pr}")
        # steps before the first switch (the mid-flight admission among
        # them), between the switches and after the last one
        spans = [[float(x) for x in span.split()] for span in
                 " ".join("x" if x is None else repr(x)
                          for x in diffs).split("x")]
        check(len(spans) == 4 and all(spans) and len(spans[0]) >= 3,
              f"{name}: a span between switches served no step: {diffs}")
        # bit-equal until the first hand-off and after every transfer one;
        # a recompute's prefill-shaped products round otherwise than the
        # decode steps' (phase 5): within LOGIT_RTOL of the largest logit
        limit = 0.0
        for span, h in zip(spans, [None] + hand):
            if h is not None and h.mode == "recompute":
                limit = LOGIT_RTOL * scale
            check(all(x <= limit for x in span),
                  f"{name}: logits differ from the unswitched twin by "
                  f"{span} after a {h.mode if h else 'no'} hand-off (limit "
                  f"{limit})")
        free_memory()
        return row

    runs = {"switch_b2": stream("switch_b2", None),
            "switch_a": stream("switch_a", None),
            "pause_resume": stream("pause_resume", None),
            "switch_b2 transfer": stream("switch_b2", "transfer"),
            "switch_a transfer": stream("switch_a", "transfer")}
    d = {k: runs[k]["downtime_s"] for k in ("switch_b2", "switch_a",
                                             "pause_resume")}
    check(d["pause_resume"] > d["switch_b2"] > d["switch_a"],
          f"7a: measured downtime order pause_resume > switch_b2 > "
          f"switch_a violated: {d}")
    check(runs["switch_a"]["switch_drops"] == 0,
          f"7a: switch_a dropped {runs['switch_a']['switch_drops']} at its "
          f"switches")
    check(runs["pause_resume"]["switch_drops"] > 0,
          "7a: pause_resume's outages dropped nothing")
    # the transfer arm: switch_b2 over switch_a.  Both strategies run the
    # same two host CRC32 passes (export and import) over the same bytes,
    # whose rate varies 3x from stream to stream (ROADMAP Queue C item 1):
    # the margin is compared net of each switch's measured passes, against
    # twice the spread of the exports' copies into page-locked memory (the
    # pool takes their blocks when it is made, so no export allocates
    # them in a switch).  The raw margin and the export walls' spread are
    # printed beside the net ones.
    tr = {k: runs[f"{k} transfer"] for k in ("switch_b2", "switch_a")}
    walls = {k: (r["handoff_wall_s"],
                 [p["handoff_parts"].get("export", {}).get("wall_s")
                  for p in r["switch_probes"]]) for k, r in tr.items()}
    held = tr["switch_b2"]["downtime_s"] > tr["switch_a"]["downtime_s"]
    exports = [x for _, ex in walls.values() for x in ex if x is not None]
    margin = tr["switch_b2"]["downtime_s"] - tr["switch_a"]["downtime_s"]
    spread = max(exports) - min(exports) if exports else None
    # each export's wall split: the copies into page-locked memory, its
    # CRC32 pass; and the import's CRC32 pass over the same bytes
    split = {k: [{key: {f: p["handoff_parts"][key][f]
                        for f in ("wall_s", "copy_s", "crc_s")}
                   for key in ("export", "import")
                   if key in p["handoff_parts"]}
                  for p in r["switch_probes"]] for k, r in tr.items()}
    crc = {k: sum(half["crc_s"] for parts in v for half in parts.values())
           for k, v in split.items()}
    copies = [parts["export"]["copy_s"] for v in split.values()
              for parts in v if "export" in parts]
    net_margin = margin - crc["switch_b2"] + crc["switch_a"]
    copy_spread = max(copies) - min(copies) if copies else None
    out.update({"transfer_order_held": held, "transfer_margin_s": margin,
                "transfer_export_spread_s": spread,
                "transfer_crc_s": crc, "transfer_net_margin_s": net_margin,
                "transfer_copy_spread_s": copy_spread,
                "transfer_handoff_parts": split})
    print(f"[serving] 7a transfer hand-offs, each half's wall, copies into "
          f"page-locked memory and CRC32 pass (s): {split}")
    print(f"[serving] 7a on the transfer arm: measured downtime switch_b2 "
          f"{tr['switch_b2']['downtime_s']:.6f} s beside switch_a "
          f"{tr['switch_a']['downtime_s']:.6f} s; switch_b2 > switch_a "
          f"{'held' if held else 'did not hold'}; raw margin {margin:.6f} s "
          f"against an export spread of {spread} s (twice it "
          f"{2 * spread:.6f} s); the CRC32 passes {crc} s; net of them "
          f"margin {net_margin:.6f} s against twice the exports' copies' "
          f"spread {copy_spread} s; hand-off and export walls "
          f"{walls} s")
    check(held and copy_spread is not None
          and net_margin >= 2 * copy_spread,
          f"7a: on the transfer arm switch_b2's downtime exceeds switch_a's "
          f"by {margin} s, {net_margin} s net of the CRC32 passes {crc}; "
          f"want switch_b2 over switch_a, and the net margin at least twice "
          f"the exports' copies' spread {copy_spread} s")
    out["streams"] = runs

    # --- 7b: the controller on the bandwidth trace, corrupted transfers --
    gclog.label = f"{SERVE_ARCH} phase 7b"
    K.reset()
    t0 = time.perf_counter()
    steps, recomputes, probes = [], [], []
    with counted(K, StatefulEdgeCloudPipeline, "process", steps):
        mgr, sm, log, admits = main_path(
            "switch_b2", L // 2, net=NetworkModel(CTL_TRACE[0][1]),
            force_mode="transfer")
        plan = faults("handoff_corrupt(p=1.0)", seed=seed).arm()
        mgr.pool.fault_plan = plan
        profile = profile_transformer(cfg, seq=1, batch=SERVE_SLOTS)
        ctl = NeukonfigController(mgr, profile,
                                  BandwidthTrace(steps=CTL_TRACE),
                                  strategy="switch_b2")
        eng = ServingEngine(mgr, clock=VirtualClock(), controller=ctl)
        log_switches(eng, mgr, sm, gclog, log, probes)
        with warnings.catch_warnings(record=True) as caught, \
                counted(K, sm, "recompute_layers", recomputes):
            warnings.simplefilter("always")
            tl = eng.run(request_stream({}, fps=CTL_FPS, duration=CTL_S))
        for _ in range(CTL_AFTER):
            mgr.active.process()
        mgr.drain()
    launches = K.read()
    wall = time.perf_counter() - t0
    add(launches)
    check_launches("7b", steps, admits)
    events = [e for e in ctl.events if e.report is not None]
    hand = mgr.pool.handoffs
    warned = [w for w in caught if issubclass(w.category,
                                              HandoffIntegrityWarning)]
    corrupted = [e for e in plan.event_log() if "handoff_corrupt" in e]
    check(len(events) >= 1, f"7b: the controller made no repartition "
                            f"({[(e.t, e.old_split, e.new_split) for e in ctl.events]})")
    check(len(hand) == len(events) and all(h.fallback and
                                           h.mode == "recompute"
                                           for h in hand),
          f"7b: hand-offs {[(h.mode, h.fallback) for h in hand]} for "
          f"{len(events)} repartitions")
    check(len(corrupted) == len(hand) == len(warned),
          f"7b: {len(corrupted)} payloads corrupted, {len(warned)} "
          f"integrity warnings, {len(hand)} hand-offs")
    want = [expected(K, cfg, min(e.old_split, e.new_split),
                     max(e.old_split, e.new_split), "full") for e in events]
    check(recomputes == want, f"7b: the fallbacks launched {recomputes}, "
                              f"want {want}")
    shut(mgr)
    diffs = replay(pool, L // 2, log)
    first = diffs.index(None)
    before, after = diffs[:first], [x for x in diffs[first:] if x is not None]
    scale = max(x.abs().max().item() for ev in log if ev[0] == "step"
                for x in ev[2].values())
    check(before and all(x == 0.0 for x in before),
          f"7b: logits differ from the twin before any switch: {before}")
    check(len(after) >= CTL_AFTER and max(after) <= LOGIT_RTOL * scale,
          f"7b: logits after the recompute fallback differ by {after} "
          f"(limit {LOGIT_RTOL} of {scale})")
    row = stream_row(tl, admits, launches, diffs, wall)
    row.update({"repartitions": [[e.t, e.bandwidth_mbps, e.old_split,
                                  e.new_split] for e in events],
                "handoffs": [{"mode": h.mode, "fallback": h.fallback,
                              "moved_layers": h.moved_layers,
                              "bytes": h.moved_bytes, "wall_s": h.t_wall,
                              "network_s": h.t_network} for h in hand],
                "fault_events": plan.event_log(),
                "recompute_launches": recomputes,
                "switch_probes": probes,
                "max_logit_diff_after": max(after),
                "logit_limit": LOGIT_RTOL * scale})
    out["controller"] = row
    print(f"[serving] 7b switch_b2 under the controller on {CTL_TRACE}: "
          f"repartitions {row['repartitions']} (t, Mbps, split -> split); "
          f"hand-offs {row['handoffs']}; measured downtime "
          f"{row['downtime_s']:.6f} s, switch drops {row['switch_drops']}, "
          f"dropped {row['dropped']} of {row['arrived']}; p50 "
          f"{row['p50_ms']} ms, p99 {row['p99_ms']} ms; max |logit diff| "
          f"after the fallback {max(after):.3e} (limit "
          f"{LOGIT_RTOL * scale:.3e}); {wall:.1f} s")
    for pr in probes:
        print(f"[serving] 7b probe: {pr}")
    free_memory()
    print(f"[serving] phase 7 launches {out['launches']}")
    return out


# ---------------------------------------------------------------------------
# phase 8: the paper's own CNNs at 224 px (no kernel of the port runs here)
# ---------------------------------------------------------------------------

CNN_ARCHS = ("vgg19", "mobilenetv2")
CNN_STRATEGIES = ("switch_b2", "switch_a", "pause_resume")
# examples/serve_pipeline_torch.py's loop: the compressed trace, 4 fps
CNN_TRACE = [(0.0, 20.0), (8.0, 5.0), (16.0, 20.0)]
CNN_FPS, CNN_S = 4.0, 24.0
CNN_FRAMES = 8                      # distinct frames, cycled
CNN_REPS = 5                        # profile_cnn's timed calls a unit
# the paper's downtimes, measured on its CPU testbed (VGG19 and
# MobileNetV2): printed beside the card's, not a target
PAPER_DOWNTIME = {"pause_resume": "6 s", "switch_b2": "0.6 s",
                  "switch_a": "< 1 ms"}


@contextlib.contextmanager
def recorded_frames(seen: list, index: dict):
    """Append ``(frame index, logits)`` to ``seen`` for every
    ``EdgeCloudPipeline.process`` call while the context is open (the
    stream's frames and the pool's warm-up forwards, on any thread)."""
    from repro_torch.core.pipeline import EdgeCloudPipeline
    real = EdgeCloudPipeline.process

    def rec(self, inputs, **kw):
        out = real(self, inputs, **kw)
        seen.append((index[id(inputs["image"])], out[0]))
        return out
    EdgeCloudPipeline.process = rec
    try:
        yield seen
    finally:
        EdgeCloudPipeline.process = real


def split_decisions(profile) -> dict:
    """Eq. 1's optimum at each of the trace's bandwidths: split, boundary
    bytes and the total it prices."""
    from repro_torch.core.network import NetworkModel
    from repro_torch.core.partitioner import optimal_split
    out = {}
    for bw in sorted({bw for _, bw in CNN_TRACE}, reverse=True):
        best = optimal_split(profile, NetworkModel(bw))
        out[bw] = {"split": best.split, "unit": profile.units[best.split].name,
                   "boundary_bytes": profile.units[best.split].boundary_bytes,
                   "total_s": best.total}
    return out


def reserve_cache(nbytes: int) -> None:
    """Leave ``nbytes`` free in the caching allocator's cache: one block
    allocated and freed at once.  Allocations that follow are carved out
    of it instead of calling ``cudaMalloc``."""
    block = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    del block


def cnn_stream(cfg, params, strategy: str, frames: list, index: dict,
               ckpt: str, fast: int, profile, scripted, want: list,
               on_manager=None, reserve: bool = True) -> tuple:
    """One phase-8c stream: ``CNN_FPS`` frames a second over ``CNN_TRACE``
    for ``CNN_S`` s of virtual time under ``strategy``, from split
    ``fast``, with a ``NeukonfigController`` on ``profile`` (or, where
    ``scripted`` names two splits, switches scripted between them at the
    trace's change points).  ``on_manager(mgr)`` is called once the
    manager is made, before the stream (a probe's hook).

    With ``reserve`` the stream's weight copies come out of memory the
    allocator holds before the stream (``reserve_cache``, two copies):
    a switch_a re-arms its standby by copying the weights on the build
    worker, and a ``cudaMalloc`` there under the allocator's lock
    stalled the serving thread's forward for up to ~240 ms, four times
    that on the edge's clock, and dropped frames (ROADMAP Queue C item
    14; PERF.md).  This is faithful to the stream: switch_a holds two
    copies (Table I's 2x) whenever it serves, and a deployment sizes its
    memory before it serves; the frames, switches, builds on the worker
    and the memory reported are as they were, only where the bytes come
    from moves before the stream.  Returns ``(row, timeline, seen)``:
    the stream's readings, its ``ServiceTimeline`` and every forward's
    ``(frame index, logits)``."""
    from repro_torch.core.controller import NeukonfigController
    from repro_torch.core.downtime import crosscheck_timeline
    from repro_torch.core.network import BandwidthTrace
    from repro_torch.core.stages import CnnStageRunner, param_bytes
    from repro_torch.core.switching import PipelineManager
    from repro_torch.serving import ServingEngine, VirtualClock

    times = [i / CNN_FPS for i in range(int(CNN_S * CNN_FPS))]
    source = [(t, {"image": frames[i % CNN_FRAMES]})
              for i, t in enumerate(times)]
    trace = BandwidthTrace(steps=CNN_TRACE)
    mgr = PipelineManager(
        CnnStageRunner(cfg, params, device="cuda"), split=fast,
        net=trace.at(0.0), sample_inputs={"image": frames[0]},
        warm_standbys=True, checkpoint_path=ckpt)
    mgr.pool.executor.submit(lambda: None).wait()
    if on_manager is not None:
        on_manager(mgr)
    ctl = None
    if scripted is None:
        ctl = NeukonfigController(mgr, profile, trace, strategy=strategy)
        eng = ServingEngine(mgr, clock=VirtualClock(), controller=ctl)
    else:
        mgr.get_strategy(strategy).prepare(
            mgr.pool, candidate_splits=scripted[::-1])
        eng = ServingEngine(mgr, clock=VirtualClock())
        for i, (t, bw) in enumerate(CNN_TRACE[1:]):
            eng.schedule_switch(t, strategy, scripted[(i + 1) % 2],
                                bandwidth_mbps=bw)
    if reserve:
        reserve_cache(2 * param_bytes(params))
    seen = []
    sw = time.perf_counter()
    with recorded_frames(seen, index):
        tl = eng.run(iter(source), duration=CNN_S)
        mgr.drain()
    wall = time.perf_counter() - sw
    mem = mgr.memory_report()
    shut(mgr)
    summ = tl.summary()
    xc = [x for x in crosscheck_timeline(tl, fps=CNN_FPS, service_time=0.0)
          if x["full_outage"]]
    worst = max((max_diff(lg, want[i]) for i, lg in seen), default=None)
    row = {"downtime_s": tl.downtime(),
           "switch_drops": tl.switch_drops(wake=1.0),
           "arrived": summ["arrived"], "dropped": summ["dropped"],
           "p50_ms": summ["p50_ms"], "p99_ms": summ["p99_ms"],
           "windows": [[w.t_start, w.duration, w.old_split, w.new_split]
                       for w in tl.windows],
           "memory_x": mem["total_bytes"] / max(mem["initial_bytes"], 1),
           "memory": mem, "forwards_checked": len(seen),
           "max_logit_diff": worst,
           "crosscheck": [[x["measured_dropped"], x["predicted_dropped"]]
                          for x in xc],
           "wall_s": wall}
    return row, tl, seen


def phase_cnn(K: Counts, arch: str, seed: int, gclog: GcLog) -> dict:
    """``arch`` (vgg19, mobilenetv2) at the published 224 px, batch 1,
    f32 (TF32 off), random weights from a generator seeded with ``seed``:

    a. every split's edge-then-cloud logits bit-equal to the monolithic
       forward's;
    b. ``profile_cnn`` on the card (each unit's time and boundary bytes)
       and Eq. 1's optimum at 20 and 5 Mbps under the reference's default
       specs and under ``edge=EDGE_SPEC, cloud=H100``;
    c. examples/serve_pipeline_torch.py's loop on the card: ``CNN_FPS``
       frames a second over ``CNN_TRACE`` for ``CNN_S`` s of virtual time
       under switch_b2, switch_a and pause_resume (reloading a checkpoint
       this phase writes to ``$TMPDIR`` and deletes), a
       ``NeukonfigController`` on the first pricing whose optimum moves,
       else switches scripted at the trace's change points between the
       optimum and its neighbour.  Checks at least two switches a stream,
       the measured downtime order pause_resume > switch_b2 > switch_a, no
       switch drops under switch_a, ``crosscheck_timeline`` within 2 frames
       for full outages, every frame's logits bit-equal to an unswitched
       pipeline's for the same frame, and no launch of the port's kernels;
    d. prints each stream's downtime, drops, p50/p99 and Table I's memory
       (total over initial), beside the paper's CPU-testbed downtimes."""
    import tempfile

    from repro_torch.checkpoint import save_pytree
    from repro_torch.configs import get_config
    from repro_torch.core.hardware import EDGE_SPEC, H100
    from repro_torch.core.network import BandwidthTrace
    from repro_torch.core.pipeline import EdgeCloudPipeline
    from repro_torch.core.profiler import profile_cnn
    from repro_torch.core.stages import CnnStageRunner, param_bytes

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    K.reset()
    cfg = get_config(arch)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    runner = CnnStageRunner(cfg, generator=gen, device="cuda")
    params, n = runner.params, runner.num_units
    hw = cfg.input_hw
    frames = [torch.randn((1, hw, hw, cfg.input_ch), generator=gen,
                          device="cuda") for _ in range(CNN_FRAMES)]
    index = {id(f): i for i, f in enumerate(frames)}
    out = {"arch": arch, "num_units": n, "input_hw": hw,
           "param_bytes": param_bytes(params)}
    print(f"[cnn] {arch}: {n} units, {out['param_bytes']} B of f32 "
          f"weights, {hw} px, batch 1; cudnn.allow_tf32 "
          f"{torch.backends.cudnn.allow_tf32}, cudnn.deterministic "
          f"{torch.backends.cudnn.deterministic}")

    # --- a. every split against the monolithic forward ---------------------
    gclog.label = f"{arch} phase 8a"
    img = {"image": frames[0]}
    mono = runner.stage_executable(0, n, params, img, fresh=True)(
        params, img)["logits"]
    check(tuple(mono.shape) == (1, cfg.num_classes)
          and bool(torch.isfinite(mono).all()),
          f"{arch}: monolithic logits {tuple(mono.shape)}, finite "
          f"{bool(torch.isfinite(mono).all())}")

    diffs = []
    for split in range(n - 1):
        mid = runner.stage_executable(0, split + 1, params, img)(params, img)
        got = runner.stage_executable(split + 1, n, params, mid)(
            params, mid)["logits"]
        diffs.append(max_diff(got, mono))
    # cuDNN's default algorithms (no cudnn.deterministic) give this
    check(not any(diffs), f"{arch}: split logits differ from the "
                          f"monolithic forward: {diffs}")
    print(f"[cnn] {arch} 8a: all {n - 1} splits bit-equal to the "
          f"monolithic forward (max |logit| "
          f"{mono.abs().max().item():.4e})")

    # --- b. the measured profile, two pricings ---------------------------------
    gclog.label = f"{arch} phase 8b"
    pricings = {"default": {}, "h100": {"edge": EDGE_SPEC, "cloud": H100}}
    profiles = {name: profile_cnn(cfg, params, runner.units, runner.shapes,
                                  reps=CNN_REPS, **kw)
                for name, kw in pricings.items()}
    out["profile"] = [{"unit": u.name, "card_us": u.t_cloud * 1e6,
                       "card_us_h100_run": h.t_cloud * 1e6,
                       "boundary_bytes": u.boundary_bytes}
                      for u, h in zip(profiles["default"].units,
                                      profiles["h100"].units)]
    print(f"[cnn] {arch} 8b profile_cnn on the card (unit, µs, µs in the "
          f"second run, boundary B): "
          + "; ".join(f"{r['unit']} {r['card_us']:.1f} "
                      f"{r['card_us_h100_run']:.1f} {r['boundary_bytes']}"
                      for r in out["profile"]))
    out["optima"] = {name: split_decisions(p)
                     for name, p in profiles.items()}
    for name, dec in out["optima"].items():
        moved = len({d["split"] for d in dec.values()}) > 1
        print(f"[cnn] {arch} 8b Eq. 1 under the {name} pricing "
              f"(edge {'4x the card' if name == 'default' else 'EDGE_SPEC, cloud H100'}): "
              + "; ".join(f"{bw:g} Mbps -> split {d['split']} after "
                          f"{d['unit']} ({d['boundary_bytes']} B, "
                          f"{d['total_s'] * 1e3:.3f} ms)"
                          for bw, d in dec.items())
              + f"; {'moves' if moved else 'does not move'}")
    pricing = next((name for name, dec in out["optima"].items()
                    if len({d["split"] for d in dec.values()}) > 1), None)
    profile = profiles[pricing or "default"]
    fast = out["optima"][pricing or "default"][CNN_TRACE[0][1]]["split"]
    scripted = None
    if pricing is None:
        scripted = (fast, fast + 1 if fast < n - 2 else fast - 1)
    out["live"] = {"pricing": pricing, "scripted": scripted}
    print(f"[cnn] {arch} 8c: "
          + (f"a NeukonfigController on the {pricing} pricing"
             if pricing else f"no pricing moves the optimum: switches "
             f"scripted {scripted[0]} <-> {scripted[1]} at the trace's "
             f"change points"))

    # --- c. the live stream ------------------------------------------------------
    twin = EdgeCloudPipeline(CnnStageRunner(cfg, params, device="cuda"),
                             fast, BandwidthTrace(steps=CNN_TRACE).at(0.0))
    twin.build({"image": frames[0]}, cold=False)
    want = [twin.process({"image": f})[0] for f in frames]
    twin.close()
    del twin
    fd, ckpt = tempfile.mkstemp(suffix=".npz")
    os.close(fd)
    streams = {}
    try:
        sw = time.perf_counter()
        out["checkpoint_bytes"] = save_pytree(params, ckpt)
        out["checkpoint_write_s"] = time.perf_counter() - sw
        for strategy in CNN_STRATEGIES:
            gclog.label = f"{arch} phase 8c {strategy}"
            row, tl, seen = cnn_stream(cfg, params, strategy, frames, index,
                                       ckpt, fast, profile, scripted, want)
            worst, mem = row["max_logit_diff"], row["memory"]
            wall = row["wall_s"]
            streams[strategy] = row
            print(f"[cnn] {arch} 8c {strategy}: measured downtime "
                  f"{row['downtime_s']:.6f} s over {len(tl.windows)} "
                  f"switches {row['windows']} (t, s, split -> split); "
                  f"switch drops {row['switch_drops']}, dropped "
                  f"{row['dropped']} of {row['arrived']}; p50 "
                  f"{row['p50_ms']} ms, p99 {row['p99_ms']} ms; memory "
                  f"{row['memory_x']:.2f}x of the initial "
                  f"{mem['initial_bytes']} B; {len(seen)} forwards' logits "
                  f"against the unswitched twin, max |diff| {worst}; "
                  f"outage drops measured/predicted {row['crosscheck']}; "
                  f"{wall:.1f} s")
            check(len(tl.windows) >= 2, f"{arch} {strategy}: "
                  f"{len(tl.windows)} switches, want at least 2")
            check(seen and worst == 0.0,
                  f"{arch} {strategy}: frame logits differ from the "
                  f"unswitched pipeline's by {worst}")
            check(all(abs(m - p) <= 2 for m, p in row["crosscheck"]),
                  f"{arch} {strategy}: outage drops measured/predicted "
                  f"{row['crosscheck']}")
            del tl, seen
            free_memory()
    finally:
        os.remove(ckpt)
    d = {k: streams[k]["downtime_s"] for k in CNN_STRATEGIES}
    check(d["pause_resume"] > d["switch_b2"] > d["switch_a"],
          f"{arch}: measured downtime order pause_resume > switch_b2 > "
          f"switch_a violated: {d}")
    check(streams["switch_a"]["switch_drops"] == 0,
          f"{arch}: switch_a dropped {streams['switch_a']['switch_drops']} "
          f"at its switches")
    launches = K.read()
    check(not any(launches.values()),
          f"{arch}: the CNN path launched the port's kernels {launches}")
    # --- d. beside the paper ----------------------------------------------------
    print(f"[cnn] {arch} 8d measured stream downtime "
          + ", ".join(f"{k} {d[k]:.6f} s ({streams[k]['switch_drops']} "
                      f"switch drops, memory {streams[k]['memory_x']:.2f}x)"
                      for k in CNN_STRATEGIES)
          + "; the paper's CPU testbed, not a target: "
          + ", ".join(f"{k} {v}" for k, v in PAPER_DOWNTIME.items()))
    out.update({"streams": streams, "launches": launches})
    del runner, params, frames, img, want, mono
    peak = torch.cuda.max_memory_allocated()
    free_memory()
    left = torch.cuda.memory_allocated()
    check(left <= 2 ** 30, f"{arch} left {left} B on the card after its "
          f"phase")
    out.update({"peak_device_bytes": peak, "left_device_bytes": left,
                "wall_s": time.perf_counter() - t0})
    print(f"[cnn] {arch}: phase 8 took {out['wall_s']:.1f} s; peak device "
          f"memory {peak} B; left after freeing {left} B")
    return out


# ---------------------------------------------------------------------------
# one model through phases 4-6
# ---------------------------------------------------------------------------

# (arch, layer splits 1/2 -> 1/4 -> 1/2 -> 3/4 of the depth); zamba2's
# 20 -> 40 and 40 -> 60 moves carry shared-attention applications across
MODELS = ("qwen2.5-3b", "falcon-mamba-7b", "zamba2-7b", "qwen2-moe-a2.7b",
          "internvl2-76b")
# depth cut for memory: phases 4-6 hold up to four weight copies on the
# card (the runner's, a standby's and its successor, a pause_resume
# reload), so a model runs at about falcon-mamba-7b's 14.6 GB:
# qwen2-moe-a2.7b's 24 layers are 28.6 GB in bf16, 12 are 14.9 GB;
# internvl2-76b's 80 are 141 GB (1.71 GB a layer, 4.33 GB of embedding,
# untied head and vision_proj), 6 are 14.6 GB
DEPTH = {"qwen2-moe-a2.7b": 12, "internvl2-76b": 6}
# the models whose cloud stage phase 12 runs on the mesh after their
# phases 4-6 (and 7); whisper-medium's runs in phase 10
SHARD_ARCHS = ("qwen2.5-3b", "falcon-mamba-7b", "zamba2-7b",
               "qwen2-moe-a2.7b")


def run_model(K, arch, seed, gclog: GcLog) -> dict:
    """Full-width ``arch`` in bf16 (random weights from a generator seeded
    with ``seed``) through the stateful decode path, both hand-off arms
    and the stateless path (a vision model's request carries its seeded
    patch embeddings; its stateful prompt is text only, as the reference
    serves it), then for a vision model the standalone prefill of the
    same request and ``STANDALONE_STEPS`` decode steps; frees the weights
    and the checkpoint after."""
    import shutil
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.core.network import NetworkModel
    from repro_torch.core.stages import param_bytes
    from repro_torch.models.transformer import init_model

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(arch)
    if arch in DEPTH:
        cfg = dataclasses.replace(cfg, num_layers=DEPTH[arch])
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
        free_memory()
        sa = None
        if cfg.frontend == "vision":
            gclog.label = f"{arch} standalone"
            tg = torch.Generator().manual_seed(seed + 5)
            extra = torch.randint(0, cfg.vocab_size, (1, STANDALONE_STEPS),
                                  generator=tg).cuda()
            sa = phase_standalone(K, cfg, params,
                                  stateless_request(cfg, seed + 2), extra,
                                  MAX_SEQ)
            free_memory()
        sv = sh = ct = None
        if arch == COUNT_ARCH:
            gclog.label = f"{arch} phase 13b"
            ct = phase_counter(K, cfg, params, seed)
            free_memory()
        if arch == SERVE_ARCH:
            t7 = time.perf_counter()
            sv = phase_serving(K, cfg, params, ckpt, seed, gclog)
            sv["phase_wall_s"] = time.perf_counter() - t7
            print(f"[serving] phase 7 took {sv['phase_wall_s']:.1f} s")
            free_memory()
        if arch in SHARD_ARCHS:
            # phase 12 keeps its own peak: the model's so far is kept here
            peak_before = torch.cuda.max_memory_allocated()
            sh = phase_sharding(K, cfg, params, seed, gclog)
    finally:
        if ckpt is not None:
            os.remove(ckpt)
    del params
    peak = torch.cuda.max_memory_allocated()
    if sh is not None:
        peak = max(peak, peak_before)
    free_memory()
    # the startup-heap freeze (core/heap.py) must pin nothing of a model
    left = torch.cuda.memory_allocated()
    check(left <= 2 ** 30, f"{arch} left {left} B on the card after its "
          f"phases")
    wall = time.perf_counter() - t0
    print(f"[{arch}] phases 4-{12 if sh else 7 if sv else 6} took {wall:.1f} s; checkpoint "
          f"{sl['checkpoint_bytes']} B; peak device memory {peak} B; "
          f"left after freeing {left} B")
    out = {"arch": arch, "num_layers": L, "splits": splits,
           "wall_s": wall, "peak_device_bytes": peak,
           "left_device_bytes": left, "stateful": sl, "stateless": st}
    if sv is not None:
        out["serving"] = sv
    if sh is not None:
        out["sharding"] = sh
    if sa is not None:
        out["standalone"] = sa
    if ct is not None:
        out["counter"] = ct
    return out


# ---------------------------------------------------------------------------
# phase 12: the sharded cloud stage
# ---------------------------------------------------------------------------

SHARD_MESH = (2,)
SHARD_STEPS = 8
SHARD_POS = (64, 1024, 2048)
# depth cut for memory: phase 12 holds the loaded model beside ~5.6 more
# logical copies of the weights it runs (a mesh copy a built pipeline,
# switch_a's standby and its re-armed successor each owning a copy and its
# mesh copy; qwen2.5-3b peaks at 40.85 GB on 6.17 GB, PERF.md), so
# the 7B models run about half their phases 4-6 depth there: 32 of
# falcon-mamba-7b's 64 layers (7.81 GB), 42 of zamba2-7b's 81 (7.42 GB, 7
# shared-block applications), 6 of qwen2-moe-a2.7b's 12 (8.09 GB); the
# layers are views of the loaded stack, nothing is copied
SHARD_DEPTH = {"falcon-mamba-7b": 32, "zamba2-7b": 42, "qwen2-moe-a2.7b": 6}


def shard_mapping() -> list:
    """One shard a card where there are two, else both on ``cuda:0``."""
    n = SHARD_MESH[-1]
    if torch.cuda.device_count() >= n:
        return [f"cuda:{i}" for i in range(n)]
    return ["cuda:0"] * n


def shard_cut(cfg, params):
    """``cfg`` and ``params`` at ``SHARD_DEPTH``'s depth: the first layers
    of the stack, as views (the shared block and the head kept)."""
    n = SHARD_DEPTH.get(cfg.name)
    if n is None or n >= cfg.num_layers:
        return cfg, params
    from repro_torch.core.stages import tree_map
    print(f"[shard] {cfg.name}: phase 12 runs {n} of its {cfg.num_layers} "
          f"layers (cut for memory; full width)")
    return (dataclasses.replace(cfg, num_layers=n),
            dict(params, layers=tree_map(lambda t: t[:n], params["layers"])))


def shard_attention(cfg) -> tuple:
    """One shard's attention at the config's width on the mesh (B, H, KH,
    D) and its full-sequence calls (Sq, Sk, causal): whisper's decoder
    (448 tokens) and cross attention (against 1500 frames), or the
    1024- and 2048-row causal prefill."""
    tp = SHARD_MESH[-1]
    full = dict(B=1, H=cfg.num_heads // tp,
                KH=max(cfg.num_kv_heads // tp, 1), D=cfg.head_dim)
    if cfg.family == "audio":
        T = WHISPER_TOKENS
        return full, ((T, T, True), (T, cfg.encoder.context_len, False))
    return full, tuple((S, S, True) for S in FA_FULL_S)


def shard_kernels(cfg, seed: int, stateful: bool) -> dict:
    """12a: the kernels of the family's cloud stage at one shard's shapes
    against their plain versions (f32 and bf16), and their times in bf16:
    the attention kernels at a shard's heads (flash_decode at
    ``SHARD_POS`` over ``MAX_SEQ`` rows where the stateful path runs),
    mamba1_scan over a shard's channels and ssd_scan over its heads, at a
    decode step (S 1, from a state) and the prompt (S 1024)."""
    from repro_torch.core.hardware import H100, H100_F32_FLOPS
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import flash_decode as FD
    from repro_torch.kernels import mamba_scan as MS
    from repro_torch.kernels import ssd_scan as SD
    errs, rel, hold = tally()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    tp = SHARD_MESH[-1]
    out = {}

    def rand(shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device="cuda", dtype=dtype)

    def inputs(B, Sq, Sk, H, KH, D, dtype):
        return (rand((B, Sq, H, D), dtype), rand((B, Sk, KH, D), dtype),
                rand((B, Sk, KH, D), dtype))

    if cfg.family != "ssm":
        full, calls = shard_attention(cfg)
        B, H, KH, D = (full[x] for x in ("B", "H", "KH", "D"))
        for dtype in (torch.float32, torch.bfloat16):
            bf16 = dtype == torch.bfloat16
            if stateful:
                q = rand((B, 1, H, D), dtype)
                k, v = rand((B, KH, MAX_SEQ, D), dtype), \
                    rand((B, KH, MAX_SEQ, D), dtype)
                for pos in SHARD_POS:
                    pos_t = torch.tensor(pos, dtype=torch.int32,
                                         device="cuda")
                    hold(FD.flash_decode_attention(q, k, v, pos=pos_t),
                         FD.flash_decode_attention_plain(q, k, v, pos=pos_t),
                         f"flash_decode shard {full} pos {pos}", bf16)
            if stateful and cfg.name == SERVE_ARCH:
                # 12e's slot pool: a row's own position, one a slot
                B4 = len(SLOT_POS)
                q = rand((B4, 1, H, D), dtype)
                k, v = rand((B4, KH, MAX_SEQ, D), dtype), \
                    rand((B4, KH, MAX_SEQ, D), dtype)
                pos_t = torch.tensor(SLOT_POS, dtype=torch.int32,
                                     device="cuda")
                hold(FD.flash_decode_attention(q, k, v, pos=pos_t),
                     FD.flash_decode_attention_plain(q, k, v, pos=pos_t),
                     f"flash_decode shard {dict(full, B=B4)} per-row pos "
                     f"{SLOT_POS}", bf16)
            for Sq, Sk, causal in calls:
                qa, ka, va = inputs(B, Sq, Sk, H, KH, D, dtype)
                hold(FA.flash_attention(qa, ka, va, causal=causal),
                     FA.flash_attention_plain(qa, ka, va, causal=causal),
                     f"flash_attention shard {full} {Sq}x{Sk} causal "
                     f"{causal}", bf16)
        if stateful:
            out["flash_decode"] = time_decode(FD, rand, B, H, KH, MAX_SEQ, D)
        out["flash_attention"] = [time_attention(FA, inputs, full, Sq, Sk,
                                                 causal)
                                  for Sq, Sk, causal in calls]
    if cfg.ssm is not None:
        s = cfg.ssm
        N = s.d_state
        if s.kind == "mamba1":
            Di = cfg.d_inner // tp
            name, mod, shape = "mamba1_scan", MS, {"Di": Di, "N": N}

            def make(S, dtype):
                dt = torch.nn.functional.softplus(rand((1, S, Di))).to(dtype)
                dbc = rand((1, S, 8 + 2 * N), dtype)
                return (dt, dbc[..., 8:8 + N], dbc[..., 8 + N:],
                        rand((1, S, Di), dtype), -torch.exp(rand((Di, N))
                                                            * 0.2))

            def state():
                return rand((1, Di, N))
            rate = H100_F32_FLOPS
        else:
            Hs, P = cfg.d_inner // s.head_dim // tp, s.head_dim
            name, mod, shape = "ssd_scan", SD, {"H": Hs, "P": P, "N": N}

            def make(S, dtype):
                dt = torch.nn.functional.softplus(rand((1, S, Hs)))
                xbc = rand((1, S, Hs * P + 2 * N), dtype)
                return (dt, xbc[..., Hs * P:Hs * P + N],
                        xbc[..., Hs * P + N:],
                        xbc[..., :Hs * P].reshape(1, S, Hs, P),
                        -torch.exp(rand((Hs,)) * 0.3))

            def state():
                return rand((1, Hs, P, N))
            rate = H100.flops
        scan = getattr(mod, name)
        plain = getattr(mod, name + "_plain")
        for dtype in (torch.float32, torch.bfloat16):
            for S in SCAN_S:
                args = make(S, dtype)
                h0 = state() if S == 1 else None
                y, h = scan(*args, h0=h0)
                yw, hw = plain(*args, h0=h0)
                bf16 = dtype == torch.bfloat16
                hold(y, yw, f"{name} y shard {shape} S {S}", bf16)
                hold(h, hw, f"{name} h shard {shape} S {S}", bf16)
        timed = []
        for S in SCAN_S:
            one = make(S, torch.bfloat16)
            h0 = state() if S == 1 else None
            nbytes = mod.bound_bytes(one[0], one[1], one[3], h0 is not None)
            n = max(2, -(-128 * 2 ** 20 // nbytes))
            sets = [one] + [make(S, torch.bfloat16) for _ in range(n - 1)]
            h0s = [h0 if h0 is None else state() for _ in range(n)]
            exps = MS.bound_exps(one[3], one[1]) if mod is MS else 0
            t = time_scan(lambda i: scan(*sets[i % n], h0=h0s[i % n]),
                          lambda i: plain(*sets[i % n], h0=h0s[i % n]),
                          n, 200 if S == 1 else 20, 20 if S == 1 else 2,
                          nbytes, mod.bound_flops(one[3], one[1]), rate,
                          exps)
            t["shape"] = dict(shape, B=1, S=S, dtype="bfloat16",
                              h0=h0 is not None)
            timed.append(t)
            print(f"[shard] {name} at a shard's {shape}, bf16, S={S}: "
                  f"kernel {t['ms']:.5f} ms, plain {t['plain_ms']:.5f} ms, "
                  f"bound {t['bound_ms']:.6f} ms ({t['bound_term']})")
            del sets, h0s
        out[name] = timed
    print(f"[shard] {cfg.name}: the kernels at a shard's shapes match their "
          f"plain versions: max abs err {errs}, bf16 at most "
          f"{rel['bfloat16']:.3e} of max|plain|")
    return dict(out, max_abs_err=errs, bf16_rel=rel["bfloat16"])


@contextlib.contextmanager
def recorded_routes(log: list):
    """Append to ``log`` every MoE routing's choice a token (its experts
    and whether each assignment was kept; ``layers.moe_route``) while
    open."""
    from repro_torch.models import layers as Lyr
    real = Lyr.moe_route

    def run(router, x, **kw):
        r = real(router, x, **kw)
        log.append(torch.cat([r["idx"], r["keep"].reshape(r["idx"].shape)],
                             -1).cpu())
        return r
    Lyr.moe_route = run
    try:
        yield log
    finally:
        Lyr.moe_route = real


def rerouted(one: list, mesh: list, at: int, tp: int) -> torch.Tensor:
    """The tokens whose MoE routing in a pass with layers ``[at, L)`` on
    the mesh differs from one device's in any layer (``recorded_routes``:
    ``one`` a routing a layer; ``mesh`` one a layer on the edge, then one
    a shard a layer on the mesh, every shard's checked equal)."""
    if not one and not mesh:                # no MoE
        return torch.zeros(0, dtype=torch.bool)
    check(len(mesh) == at + tp * (len(one) - at),
          f"{len(mesh)} routings on the mesh for {len(one)} layers")
    out = torch.zeros(one[0].shape[0], dtype=torch.bool)
    for li, a in enumerate(one):
        if li < at:
            b = mesh[li]
        else:
            shards = mesh[at + (li - at) * tp:at + (li - at + 1) * tp]
            check(all(torch.equal(x, shards[0]) for x in shards),
                  f"layer {li}: the shards route differently")
            b = shards[0]
        out |= (a != b).any(-1)
    return out


def row_diffs(x, ref) -> torch.Tensor:
    """Each row's (token's) largest |logit diff|."""
    return (x.float() - ref.float()).abs().reshape(-1, x.shape[-1]) \
        .amax(-1).cpu()


MOE_F32_LAYERS = 2


def moe_in_f32(cfg, params, prompt, tp: int) -> dict:
    """An MoE's cloud stage on the mesh in f32, where no rounding flips a
    routing: the first ``MOE_F32_LAYERS`` layers at full width, every one
    on the mesh (split 0), against one device's forward.  Every token
    must route alike and the logits agree within ``FP32_ATOL`` of the
    largest."""
    from repro_torch.core.network import NetworkModel
    from repro_torch.core.pipeline import EdgeCloudPipeline
    from repro_torch.core.stages import StageRunner, tree_map
    n = MOE_F32_LAYERS
    cfg = dataclasses.replace(cfg, num_layers=n)
    p32 = tree_map(lambda t: t.float(), dict(
        params, layers=tree_map(lambda t: t[:n], params["layers"])))
    runner = StageRunner(cfg, p32, attn_impl="kernel", device="cuda")
    with recorded_routes([]) as one:
        mono = runner.run_units(prompt, 0, runner.num_units)["logits"]
    pipe = EdgeCloudPipeline(runner, 0, NetworkModel(20.0),
                             mesh_shape=SHARD_MESH)
    pipe.build(prompt, cold=False)
    with recorded_routes([]) as mesh:
        got, _ = pipe.process(prompt)
    pipe.close()
    moved = int(rerouted(one, mesh, 0, tp).sum())
    scale = mono.abs().max().item()
    err = max_diff(got, mono)
    print(f"[shard] {cfg.name} in f32, {n} layers on the mesh: tokens "
          f"re-routed {moved}; max |logit diff| {err:.3e} (max |logit| "
          f"{scale:.3e})")
    check(moved == 0 and err <= FP32_ATOL * scale,
          f"{cfg.name} in f32 on the mesh: {moved} tokens re-routed, "
          f"logits off by {err} (> {FP32_ATOL} of {scale})")
    del runner, p32, mono, got
    free_memory()
    return {"layers": n, "rerouted_rows": moved, "max_logit_diff": err,
            "max_logit": scale}


def all_reduces(cfg, lo: int, hi: int) -> int:
    """All-reduces a pass over layers [lo, hi) on the mesh makes when no
    block degrades: 2 an attention + MLP or MoE layer or shared-block
    application (after ``wo`` and the MLP's ``w_down``), 2 a Mamba layer
    (Mamba-1: ``x_proj``'s outputs and ``out_proj``; Mamba-2: the gated
    norm's sum of squares and ``out_proj``), 3 a whisper decoder layer
    (its cross attention's ``wo`` besides)."""
    if cfg.family == "audio":
        return 3 * (hi - lo)
    from repro_torch.core.stateful import unit_index_of_split, unit_list
    return 2 * len(unit_list(cfg)[unit_index_of_split(cfg, lo):
                                  unit_index_of_split(cfg, hi)])


def all_reduce_ms(shape, devices, calls: int) -> float:
    """Device milliseconds of ``calls`` all-reduces of bf16 partials of
    ``shape`` over ``devices`` (CUDA events)."""
    from repro_torch.distributed import tp as TP
    parts = [torch.randn(shape, device=d, dtype=torch.bfloat16)
             for d in devices]
    before = TP.all_reduce.calls
    ms = cuda_ms(lambda i: TP.all_reduce(parts, devices), 50) * calls
    TP.all_reduce.calls = before
    return ms


def phase_sharding(K, cfg, params, seed, gclog: GcLog, *,
                   stateful: bool = True) -> dict:
    """Phase 12 for ``cfg`` at full width (its weights loaded; cut to
    ``SHARD_DEPTH`` by ``shard_cut``): the kernels at a shard's shapes,
    then the stateless and (``stateful``) the stateful pipelines moved
    onto a 2-way tensor-parallel mesh and back."""
    from repro_torch.core.network import NetworkModel
    from repro_torch.core.profiler import calibrate_mesh, profile_transformer
    from repro_torch.core.stages import StageRunner
    from repro_torch.core.switching import PipelineManager
    from repro_torch.distributed import tp as TP
    from repro_torch.launch.mesh import reset_mesh_devices, set_mesh_devices

    t0 = time.perf_counter()
    cfg, params = shard_cut(cfg, params)
    arch = cfg.name
    mapping = shard_mapping()
    tp = SHARD_MESH[-1]
    set_mesh_devices(mapping)
    one_card = len(set(mapping)) < tp
    print(f"[shard] {arch}: mesh {SHARD_MESH} on {mapping} "
          f"({torch.cuda.device_count()} card(s) visible): "
          + ("every shard on one card: no link between the shards, and no "
             "tensor-parallel speed-up is measured" if one_card
             else "one shard a card"))
    try:
        kern = shard_kernels(cfg, seed + 12, stateful)
        free_memory()
        L = cfg.num_layers
        split, other = L // 2, L // 4
        torch.cuda.reset_peak_memory_stats()
        K.reset()
        # --- 12b: the stateless pipeline ------------------------------
        gclog.label = f"{arch} phase 12b"
        prompt = stateless_request(cfg, seed + 2)
        rows = prompt["tokens"].shape[1] + cfg.frontend_tokens
        runner = StageRunner(cfg, params, attn_impl="kernel", device="cuda")
        mgr = PipelineManager(runner, split=split, net=NetworkModel(20.0),
                              sample_inputs=prompt)
        request_ms = {"one device": [], "mesh": []}
        timings = []

        def serve(at: int, on_mesh: bool):
            before = K.read()
            logits, timing = mgr.serve(prompt)
            torch.cuda.synchronize()
            got = K.since(before)
            want = expected(K, cfg, 0, at, "full")
            cloud = expected(K, cfg, at, L, "full")
            for name, n in scaled(cloud, tp if on_mesh else 1).items():
                want[name] += n
            check(got == want, f"phase 12b {arch}: a request at split {at} "
                               f"(mesh {on_mesh}) launched {got}, want {want}")
            request_ms["mesh" if on_mesh else "one device"].append(
                (timing.t_edge / mgr.active.edge_scale + timing.t_cloud)
                * 1e3)
            if on_mesh:
                timings.append(timing)
            return logits.float()

        # an MoE's routing is recorded around each request: a bf16
        # rounding of the mesh's partial sums can flip a near-tie between
        # two experts, and capacity then re-routes other tokens too
        routes = {"one device": [], "mesh": []}

        def routed(at: int, on_mesh: bool):
            with recorded_routes([]) as log:
                x = serve(at, on_mesh)
            routes["mesh" if on_mesh else "one device"].append((at, log))
            return x

        first = routed(split, False)
        scale = first.abs().max().item()
        mgr.set_mesh_shape(SHARD_MESH)
        reps = [mgr.repartition("switch_b2", split)]
        ar0 = TP.all_reduce.calls
        on_mesh = [routed(split, True), routed(split, True)]
        ar_request = (TP.all_reduce.calls - ar0) // 2
        check(ar_request == all_reduces(cfg, split, L),
              f"phase 12b {arch}: {ar_request} all-reduces a request, want "
              f"{all_reduces(cfg, split, L)}")
        check(torch.equal(on_mesh[0], on_mesh[1]),
              f"phase 12b {arch}: two requests on one mesh are not "
              f"bit-equal")
        mgr.build_standby(other)
        reps.append(mgr.repartition("switch_a", other))
        mgr.drain()
        on_mesh.append(routed(other, True))
        n_self = L if cfg.family == "audio" \
            else expected(K, cfg, 0, L, "full")["flash_attention"]
        bound = request_bound_ms(cfg, params, rows,
                                 attention_flops(cfg, rows, n_self)
                                 + frontend_flops(cfg, params, rows))
        prof_mesh = profile_step(lambda: mgr.serve(prompt)[0], bound,
                                 device_kernels(cfg))[1]
        mgr.set_mesh_shape(None)
        reps.append(mgr.repartition("switch_b2", other))
        back = serve(other, False)
        reshards = list(mgr.pool.reshards)
        shut(mgr)
        launches = K.read()       # the main path's; not the twin's below
        # tokens re-routed on the mesh (an MoE's; none elsewhere) are
        # counted and their rows' differences printed; every other row
        # within LOGIT_RTOL of the largest logit
        one_routes = routes["one device"][0][1]
        moved = [rerouted(one_routes, log, at, tp)
                 for at, log in routes["mesh"]]
        rows_diff = [row_diffs(x, first) for x in on_mesh]
        mesh_diffs = [d[~m].max().item() if m.numel() else d.max().item()
                      for d, m in zip(rows_diff, moved)]
        moved_rows = [int(m.sum()) for m in moved]
        moved_diffs = [d[m].max().item() if m.any() else 0.0
                       for d, m in zip(rows_diff, moved)]
        check(max(mesh_diffs) <= LOGIT_RTOL * scale,
              f"phase 12b {arch}: mesh logits differ from one device's by "
              f"{mesh_diffs} (> {LOGIT_RTOL} of {scale}) on rows the mesh "
              f"routed as one device")
        check(all(bool(torch.isfinite(x).all()) for x in on_mesh),
              f"phase 12b {arch}: non-finite logits on the mesh")
        check(torch.equal(back, first), f"phase 12b {arch}: logits back on "
                                        f"one device differ from the first")
        check([r.mesh_change for r in reps] == [True, False, True]
              and [(r.old_mesh, r.new_mesh) for r in reps[::2]]
              == [(None, SHARD_MESH), (SHARD_MESH, None)],
              f"phase 12b {arch}: mesh transitions "
              f"{[(r.old_mesh, r.new_mesh) for r in reps]}")
        check(len(reshards) == 2 and all(r.moved_bytes == 0
                                         for r in reshards),
              f"phase 12b {arch}: reshards {reshards}: a built pipeline's "
              f"transition must move no weight bytes")
        for r, rs in zip((reps[0], reps[2]), reshards):
            check(r.t_reshard == rs.t_wall and r.t_reshard >= 0.0,
                  f"phase 12b {arch}: {r.strategy}'s t_reshard "
                  f"{r.t_reshard} is not its ReshardReport's {rs.t_wall}")
        profile = profile_transformer(cfg, seq=rows)
        alpha_beta = calibrate_mesh(profile, timings, split=split,
                                    mesh_shape=SHARD_MESH)
        for r in reps:
            print(f"[shard] {arch} stateless {r.strategy}: split "
                  f"{r.old_split} -> {r.new_split}, mesh {r.old_mesh} -> "
                  f"{r.new_mesh}, downtime {r.downtime:.6f} s, t_reshard "
                  f"{r.t_reshard:.6f} s")
        print(f"[shard] {arch} stateless: reshards {reshards}; max |logit "
              f"diff| on the mesh {mesh_diffs} (max |logit| {scale:.3e}); "
              f"tokens the mesh re-routed (MoE) {moved_rows} of {rows}, "
              f"their rows' max |logit diff| {moved_diffs}; "
              f"request wall (edge + cloud, unscaled) ms {request_ms}; "
              f"all-reduces a request {ar_request}; calibrate_mesh scales "
              f"(alpha, beta) {alpha_beta} on {mapping}: fitted to walls "
              f"with no link between the shards, not a tensor-parallel "
              f"speed; profiled request on the mesh: {prof_mesh}")
        del runner, first, on_mesh, back
        free_memory()
        f32 = moe_in_f32(cfg, params, prompt, tp) if cfg.moe is not None \
            else None
        t_reshard_build = reps[0].build_detail.t_reshard
        peak = torch.cuda.max_memory_allocated()
        devs = [torch.device(x) for x in mapping]
        ar = {"request_calls": ar_request,
              "request_ms": all_reduce_ms((1, rows, cfg.d_model), devs,
                                          ar_request)}
        result = {"arch": arch, "num_layers": L, "mapping": mapping,
                  "mesh": list(SHARD_MESH), "kernels": kern,
                  "stateless": {"request_ms": request_ms,
                                "logit_diff": mesh_diffs,
                                "rerouted_rows": moved_rows,
                                "rerouted_logit_diff": moved_diffs,
                                "downtime_s": [(r.strategy, r.downtime)
                                               for r in reps],
                                "reshards": [vars(r) for r in reshards],
                                "calibrate_mesh": list(alpha_beta),
                                "build_t_reshard_s": t_reshard_build,
                                "profiled_request_mesh": prof_mesh,
                                "moe_f32": f32},
                  "all_reduce": ar}
        if stateful:
            K.reset()
            sf = phase_sharding_stateful(K, cfg, params, seed, gclog, split)
            launches = {k: launches[k] + n
                        for k, n in sf.pop("launches").items()}
            ar["step_calls"] = sf.pop("step_all_reduces")
            ar["step_ms"] = all_reduce_ms((1, 1, cfg.d_model), devs,
                                          ar["step_calls"])
            result["stateful"] = sf
            peak = max(peak, sf["peak_device_bytes"])
            if arch == SERVE_ARCH:
                K.reset()
                sp = phase_sharding_pool(K, cfg, params, seed, gclog,
                                         split)
                launches = {k: launches[k] + n
                            for k, n in sp.pop("launches").items()}
                result["slot_pool"] = sp
                peak = max(peak, sp["peak_device_bytes"])
        print(f"[shard] {arch}: all-reduces {ar}; peak device memory "
              f"{peak} B; the stateless switch_b2's BuildReport.t_reshard "
              f"{t_reshard_build:.6f} s")
    finally:
        reset_mesh_devices()
    free_memory()
    wall = time.perf_counter() - t0
    print(f"[shard] {arch}: phase 12 took {wall:.1f} s")
    return dict(result, launches=launches, wall_s=wall,
                peak_device_bytes=peak)


def phase_sharding_stateful(K, cfg, params, seed, gclog: GcLog,
                            split: int) -> dict:
    """12c: the stateful pipeline (prompt ``PROMPT``, ``MAX_SEQ``):
    ``SHARD_STEPS`` steps on one device, switch_b2 onto the mesh at the
    same split, as many steps, back, as many again; each step's launches
    and logits against an unswitched session fed the same tokens, each
    transition moving exactly the live cloud-range state (KV, conv and
    SSM state).  Launches are read before the twin runs."""
    from repro_torch.core.network import NetworkModel
    from repro_torch.core.stateful import make_stateful_manager
    from repro_torch.distributed import tp as TP

    arch, L, tp = cfg.name, cfg.num_layers, SHARD_MESH[-1]
    gclog.label = f"{arch} phase 12c"
    torch.cuda.reset_peak_memory_stats()
    kw = dict(split=split, net=NetworkModel(20.0), prompt_len=PROMPT,
              max_seq=MAX_SEQ, seed=seed, decode_impl="auto",
              attn_impl="kernel", device="cuda")
    mgr, session = make_stateful_manager(cfg, params, **kw)
    per_step = {False: expected(K, cfg, 0, L, "decode")}
    mesh_step = expected(K, cfg, 0, split, "decode")
    for name, n in scaled(expected(K, cfg, split, L, "decode"), tp).items():
        mesh_step[name] += n
    per_step[True] = mesh_step
    logits_seen, step_ms = [], {"one device": [], "mesh": []}
    step_routes = []          # (layers on the edge, the step's routings)

    def steps(n: int, mesh: bool):
        for _ in range(n):
            before = K.read()
            with recorded_routes([]) as log:
                logits, timing = mgr.serve(None)
            step_routes.append((split if mesh else L, log))
            got = K.since(before)
            check(got == per_step[mesh], f"phase 12c {arch}: a decode step "
                  f"(mesh {mesh}) launched {got}, want {per_step[mesh]}")
            step_ms["mesh" if mesh else "one device"].append(
                (timing.t_edge / mgr.active.edge_scale + timing.t_cloud)
                * 1e3)
            logits_seen.append(logits.float().cpu())

    def state_bytes():
        a = mgr.active
        return sum(v.numel() * v.element_size() for v in
                   session.subset(a._u_edge, a._u_all).values())

    steps(SHARD_STEPS, False)
    live = state_bytes()
    mgr.set_mesh_shape(SHARD_MESH)
    r1 = mgr.repartition("switch_b2", split)
    moved1 = mgr.pool.reshards[-1].moved_bytes
    ar0 = TP.all_reduce.calls
    steps(SHARD_STEPS, True)
    ar_step = (TP.all_reduce.calls - ar0) // SHARD_STEPS
    check(ar_step == all_reduces(cfg, split, L),
          f"phase 12c {arch}: {ar_step} all-reduces a step, want "
          f"{all_reduces(cfg, split, L)}")
    _, prof_step_mesh = profile_step(
        lambda: mgr.serve(None)[0], request_bound_ms(cfg, params, 1),
        device_kernels(cfg))            # a step not in logits_seen
    live_mesh = state_bytes()
    mgr.set_mesh_shape(None)
    r2 = mgr.repartition("switch_b2", split)
    moved2 = mgr.pool.reshards[-1].moved_bytes
    steps(SHARD_STEPS, False)
    tokens = session.tokens.clone()
    stateful_reshards = list(mgr.pool.reshards)
    shut(mgr)
    launches = K.read()       # the main path's; not the twin's below
    check(r1.mesh_change and r1.new_mesh == SHARD_MESH
          and r2.mesh_change and r2.old_mesh == SHARD_MESH
          and r2.new_mesh is None,
          f"phase 12c {arch}: transitions {(r1.old_mesh, r1.new_mesh)}, "
          f"{(r2.old_mesh, r2.new_mesh)}")
    check(moved1 == live and moved2 == live_mesh == live,
          f"phase 12c {arch}: reshards moved {moved1} and {moved2} B, the "
          f"live cloud-range state is {live} B")
    # an unswitched session fed the same tokens; its step at the profiled
    # mesh step's place is profiled too, and not compared
    ref, _ = make_stateful_manager(cfg, params, **kw)
    wants, moved = [], []
    for i in range(len(logits_seen) + 1):
        feed = {"token": tokens[:, PROMPT + i:PROMPT + 1 + i]}
        if i == 2 * SHARD_STEPS:
            _, prof_step_one = profile_step(
                lambda: ref.serve(feed)[0],
                request_bound_ms(cfg, params, 1), device_kernels(cfg))
        else:
            with recorded_routes([]) as log:
                wants.append(ref.serve(feed)[0].float().cpu())
            at, got = step_routes[len(moved)]
            moved.append(bool(rerouted(log, got, at, tp).any()))
    shut(ref)
    diffs = [max_diff(a, b) for a, b in zip(logits_seen, wants)]
    agree = sum(int(a.argmax() == b.argmax())
                for a, b in zip(logits_seen, wants))
    scale = max(w.abs().max().item() for w in wants)
    # an MoE step whose token the mesh re-routed (a near-tie flipped by a
    # bf16 rounding of the partial sums) is counted, its difference
    # printed; every other step within LOGIT_RTOL of the largest logit
    kept = [d for d, m in zip(diffs, moved) if not m]
    moved_diffs = [d for d, m in zip(diffs, moved) if m]
    check(max(kept) <= LOGIT_RTOL * scale,
          f"phase 12c {arch}: logits differ from the unswitched session's "
          f"by {max(kept)} (> {LOGIT_RTOL} of {scale}) on steps routed "
          f"alike")
    check(all(bool(torch.isfinite(x).all()) for x in logits_seen),
          f"phase 12c {arch}: non-finite logits")
    med = {k: sorted(v)[len(v) // 2] for k, v in step_ms.items()}
    print(f"[shard] {arch} stateful: switch_b2 onto {SHARD_MESH} moved "
          f"{moved1} B in {r1.t_reshard:.6f} s, back moved {moved2} B in "
          f"{r2.t_reshard:.6f} s (live cloud-range state {live} B); token "
          f"agreement with the unswitched session {agree} of {len(diffs)}; "
          f"max |logit diff| {max(kept):.3e} (max |logit| {scale:.3e}); "
          f"steps re-routed (MoE) {len(moved_diffs)}, their max |logit "
          f"diff| {moved_diffs}; decode step wall (edge + cloud, "
          f"unscaled) median ms {med}; all-reduces a step {ar_step}")
    print(f"[shard] {arch} profiled decode step on the mesh: "
          f"{prof_step_mesh}; on one device: {prof_step_one}")
    return {"step_ms": step_ms, "step_ms_median": med,
            "moved_bytes": [moved1, moved2], "live_state_bytes": live,
            "t_reshard_s": [r1.t_reshard, r2.t_reshard],
            "reshards": [vars(r) for r in stateful_reshards],
            "token_agreement": [agree, len(diffs)],
            "max_logit_diff": max(kept), "max_logit": scale,
            "rerouted_steps": len(moved_diffs),
            "rerouted_logit_diff": moved_diffs,
            "profiled_step_mesh": prof_step_mesh,
            "profiled_step_one_device": prof_step_one,
            "step_all_reduces": ar_step, "launches": launches,
            "peak_device_bytes": torch.cuda.max_memory_allocated()}


# 12e: the slot pool on the mesh, the sequence of
# tools/probe_reference_slot_mesh_ops.py with POOL_STEPS steps between
POOL_STEPS = 8
POOL_LATE = (SERVE_LATE, 128)       # into the free slot, then the full pool


def phase_sharding_pool(K, cfg, params, seed, gclog: GcLog,
                        split: int) -> dict:
    """12e: a ``SERVE_SLOTS``-slot pool (``make_session_manager``, max_seq
    ``MAX_SEQ``) on the loaded weights, phase 7's prompts admitted, through
    ``POOL_STEPS`` steps between each of: switch_b2 onto the mesh at
    ``split``; an admission into the free slot; one into the full pool
    (preempts and parks); switch_b2 to ``3 L / 4`` on the mesh on the
    transfer arm, back to ``split`` and to ``3 L / 4`` again on the
    recompute arm; the readmission of the parked session (preempts in
    turn); switch_b2 off the mesh.  Checks each live session's logits
    against a twin pool that never switches, fed the same admissions and
    tokens (within ``LOGIT_RTOL`` of the largest), 0 state bytes moved
    at each mesh transition, the first step on the mesh placing exactly
    the cloud range's state, each step's launches (a mesh step's
    flash_decode: the edge layers plus tp times the cloud layers) and
    all-reduces (2 a cloud layer).  Launches are read before the twin
    runs."""
    from repro_torch.core.network import NetworkModel
    from repro_torch.distributed import tp as TP
    from repro_torch.serving import make_session_manager

    arch, L, tp = cfg.name, cfg.num_layers, SHARD_MESH[-1]
    moved_split = (3 * L) // 4
    gclog.label = f"{arch} phase 12e"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(seed + 3)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=gen)
               for n in SERVE_PROMPTS + POOL_LATE]

    def pool():
        return make_session_manager(
            cfg, params, split=split, net=NetworkModel(SERVE_MBPS),
            num_slots=SERVE_SLOTS, max_seq=MAX_SEQ, attn_impl="kernel",
            decode_impl="auto", device="cuda")

    def per_step(at: int, mesh: bool) -> dict:
        want = expected(K, cfg, 0, at, "decode")
        for name, n in scaled(expected(K, cfg, at, L, "decode"),
                              tp if mesh else 1).items():
            want[name] += n
        return want

    mgr, sm = pool()
    events, seen, step_ms = [], [], {"one device": [], "mesh": []}
    where = {"split": split, "mesh": False}

    def cloud():
        a = mgr.active
        return sm.subset(a._u_edge, a._u_all)

    def steps(n: int):
        at, mesh = where["split"], where["mesh"]
        for _ in range(n):
            tok = sm.next_token()
            before, ar0 = K.read(), TP.all_reduce.calls
            _, timing = mgr.serve({"token": tok})
            got, ar = K.since(before), TP.all_reduce.calls - ar0
            check(got == per_step(at, mesh), f"phase 12e {arch}: a step at "
                  f"split {at} (mesh {mesh}) launched {got}, want "
                  f"{per_step(at, mesh)}")
            want_ar = all_reduces(cfg, at, L) if mesh else 0
            check(ar == want_ar, f"phase 12e {arch}: {ar} all-reduces a "
                                 f"step, want {want_ar}")
            step_ms["mesh" if mesh else "one device"].append(
                (timing.t_edge / mgr.active.edge_scale + timing.t_cloud)
                * 1e3)
            events.append(("step", tok.cpu()))
            seen.append({s: sm.logits_for(s).float().cpu()
                         for s in sm.session_ids()})

    def admit(i: int):
        sm.admit(prompts[i], sid=f"s{i}")
        events.append(("admit", i))

    def readmit(sid: str):
        sm.readmit(sid)
        events.append(("readmit", sid))

    transitions = []

    def switch(at: int, mesh: bool, arm=None):
        mgr.pool.force_mode = arm
        n = len(mgr.pool.reshards)
        mgr.set_mesh_shape(SHARD_MESH if mesh else None)
        r = mgr.repartition("switch_b2", at)
        rs = mgr.pool.reshards[n:]
        transitions.append({
            "to_split": at, "mesh": mesh, "mesh_change": r.mesh_change,
            "handoff_mode": r.handoff_mode, "handoff_bytes": r.handoff_bytes,
            "reshard_moved_bytes": [x.moved_bytes for x in rs],
            "downtime_s": r.downtime})
        check(len(rs) == int(r.mesh_change) and r.mesh_change == (
            mesh != where["mesh"]) and all(x.moved_bytes == 0 for x in rs),
            f"phase 12e {arch}: switch_b2 to split {at} (mesh {mesh}): "
            f"reshards {rs}, want 0 state bytes moved (a slot pool's first "
            f"step places its state)")
        check(arm is None or r.handoff_mode == arm,
              f"phase 12e {arch}: hand-off {r.handoff_mode}, want {arm}")
        where.update(split=at, mesh=mesh)

    for i in range(len(SERVE_PROMPTS)):
        admit(i)
    steps(POOL_STEPS)
    live = sum(v.numel() * v.element_size() for v in cloud().values())
    switch(split, True)
    placed_before = {k: v for k, v in cloud().items()
                     if not isinstance(v, TP.ShardedTensor)}
    steps(1)
    placed = {k: v for k, v in placed_before.items()
              if isinstance(sm.cache[k], TP.ShardedTensor)}
    placed_bytes = sum(v.numel() * v.element_size()
                       for v in placed.values())
    check(placed.keys() == cloud().keys() and placed_bytes == live,
          f"phase 12e {arch}: the first step on the mesh placed "
          f"{placed_bytes} B of {sorted(placed)}, the live cloud-range "
          f"state is {live} B")
    steps(POOL_STEPS - 1)
    admit(len(SERVE_PROMPTS))               # into the free slot
    steps(POOL_STEPS)
    admit(len(SERVE_PROMPTS) + 1)           # into the full pool
    parked = sm.parked_ids()
    check(len(parked) == 1, f"phase 12e {arch}: parked {parked}")
    steps(POOL_STEPS)
    switch(moved_split, True, "transfer")
    steps(POOL_STEPS)
    switch(split, True, "recompute")
    steps(POOL_STEPS)
    switch(moved_split, True, "recompute")
    steps(POOL_STEPS)
    readmit(parked[0])
    steps(POOL_STEPS)
    switch(moved_split, False)
    steps(POOL_STEPS)
    check(not any(isinstance(v, TP.ShardedTensor)
                  for v in sm.cache.values()),
          f"phase 12e {arch}: state left on the mesh after a step off it")
    shut(mgr)
    launches = K.read()       # the main path's; not the twin's below
    wall = time.perf_counter() - t0
    # the twin: the same admissions and tokens, one device, never switched
    twin, tsm = pool()
    diffs, scale, n = [], 0.0, 0
    for kind, arg in events:
        if kind == "admit":
            tsm.admit(prompts[arg], sid=f"s{arg}")
        elif kind == "readmit":
            tsm.readmit(arg)
        else:
            twin.serve({"token": arg.cuda()})
            got = seen[n]
            n += 1
            check(sorted(got) == sorted(tsm.session_ids()),
                  f"phase 12e {arch}: live sessions {sorted(got)}, the "
                  f"twin's {tsm.session_ids()}")
            want = {s: tsm.logits_for(s).float().cpu() for s in got}
            diffs.append(max(max_diff(got[s], want[s]) for s in got))
            scale = max([scale] + [w.abs().max().item()
                                   for w in want.values()])
    shut(twin)
    check(max(diffs) <= LOGIT_RTOL * scale,
          f"phase 12e {arch}: live logits differ from the twin's by "
          f"{max(diffs)} (> {LOGIT_RTOL} of {scale})")
    check(all(bool(torch.isfinite(x).all()) for step in seen
              for x in step.values()),
          f"phase 12e {arch}: non-finite logits")
    med = {k: sorted(v)[len(v) // 2] for k, v in step_ms.items()}
    print(f"[shard] {arch} slot pool ({SERVE_SLOTS} slots, max_seq "
          f"{MAX_SEQ}) on {SHARD_MESH}: transitions {transitions}; the "
          f"first step on the mesh placed {placed_bytes} B (the live "
          f"cloud-range state {live} B); max |logit diff| from the twin "
          f"{max(diffs):.3e} (max |logit| {scale:.3e}) over {n} steps; "
          f"step wall median ms {med}; took {wall:.1f} s (the twin "
          f"after)")
    return {"transitions": transitions, "placed_bytes": placed_bytes,
            "live_state_bytes": live, "max_logit_diff": max(diffs),
            "max_logit": scale, "steps": n, "step_ms_median": med,
            "wall_s": wall, "launches": launches,
            "peak_device_bytes": torch.cuda.max_memory_allocated()}


# ---------------------------------------------------------------------------
# phase 10: whisper-medium at full depth
# ---------------------------------------------------------------------------

def cross_attention_share(cfg, step_prof: dict) -> dict:
    """The device time a whisper decode step spends in its cross
    attention, the plain ``layers.decode_attention`` of one query token
    against each layer's ``context_len`` cross K/V rows (bf16, the step's
    shapes and route, random values), read by the profiler as a step is
    (``profile_step``), beside the profiled step's busy time."""
    from repro_torch.models import layers as Lyr
    L, KH, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    T_enc = cfg.encoder.context_len
    gen = torch.Generator(device="cuda").manual_seed(1)
    ck, cv = (torch.randn((L, 1, KH, T_enc, hd), generator=gen,
                          device="cuda", dtype=torch.bfloat16)
              for _ in range(2))
    q = torch.randn((1, 1, cfg.num_heads, hd), generator=gen, device="cuda",
                    dtype=torch.bfloat16)

    def cross():
        return [Lyr.decode_attention(q, ck[li], cv[li], pos=T_enc)
                for li in range(L)][-1]
    cross()
    from repro_torch.core.hardware import H100
    # the least time: the cross K/V read once
    bound = 2 * ck.numel() * ck.element_size() / H100.hbm_bw * 1e3
    _, prof = profile_step(cross, bound, ())
    busy = step_prof.get("device_busy_ms")
    out = {"device_busy_ms": prof.get("device_busy_ms"),
           "wall_ms": prof.get("wall_ms"),
           "device_ops": prof.get("device_ops"), "bound_ms": bound,
           "step_device_busy_ms": busy}
    if busy and out["device_busy_ms"] is not None:
        out["share_of_step_busy"] = out["device_busy_ms"] / busy
    print(f"[whisper] the decode step's plain cross attention ({L} layers "
          f"against {T_enc} rows): {out}")
    return out


WHISPER_ARCH = "whisper-medium"


def phase_whisper(K, seed, gclog: GcLog) -> dict:
    """whisper-medium at full depth (24 encoder and 24 decoder layers,
    d_model 1024, 16 heads of 64), bf16, random weights and frames from
    seeded generators.  The stateless pipeline (phase 6's
    ``phase_stateless``): ``WHISPER_TOKENS`` tokens beside the 1500
    frames, the encoder in the edge's unit 0 and its output riding every
    boundary, splits 1/2 -> 1/4 -> 1/2 -> 3/4 of the decoder depth under
    switch_b2, switch_a and pause_resume (a checkpoint the pool writes and
    this phase deletes); checks the downtime order, logits bit-equal to
    the first request's after every switch, and 72 flash_attention
    launches a request (24 encoder, 24 self, 24 cross).  Then the
    standalone functions: ``prefill`` of the first ``WHISPER_TOKENS -
    STANDALONE_STEPS`` tokens with the frames and ``STANDALONE_STEPS``
    decode steps, 24 flash_decode launches each (the cross attention is
    the plain ``decode_attention``, as the reference's), every logit row
    held to ``forward_hidden`` over the whole sequence."""
    from repro_torch.configs import get_config
    from repro_torch.core.stages import param_bytes
    from repro_torch.models.transformer import init_model

    gclog.label = f"{WHISPER_ARCH} phase 10"
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(WHISPER_ARCH)
    L = cfg.num_layers
    splits = [L // 2, L // 4, L // 2, (3 * L) // 4]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = init_model(cfg, gen, dtype=torch.bfloat16, device="cuda")
    nbytes = param_bytes(params)
    st = phase_stateless(K, cfg, params, None, seed, splits)
    free_memory()
    request = stateless_request(cfg, seed + 2)
    P = WHISPER_TOKENS - STANDALONE_STEPS
    sa = phase_standalone(K, cfg, params,
                          dict(request, tokens=request["tokens"][:, :P]),
                          request["tokens"][:, P:], WHISPER_TOKENS)
    sa["cross_attention"] = cross_attention_share(cfg, sa["profiled_step"])
    free_memory()
    # phase 12's stateless part on the mesh (the stateful path refuses
    # whisper, as the reference's does); it keeps its own peak
    peak = torch.cuda.max_memory_allocated()
    sh = phase_sharding(K, cfg, params, seed, gclog, stateful=False)
    del params
    peak = max(peak, torch.cuda.max_memory_allocated())
    free_memory()
    wall = time.perf_counter() - t0
    req, step = st["profiled_request"], sa["profiled_step"]
    print(f"[whisper] {WHISPER_ARCH}: {cfg.encoder.num_layers} + {L} layers "
          f"(full depth), d_model {cfg.d_model}, {cfg.num_heads} heads of "
          f"{cfg.head_dim}, bf16, {nbytes} B of weights; request "
          f"({WHISPER_TOKENS} tokens, {cfg.encoder.context_len} frames) "
          f"wall median {st['request_ms_median']:.3f} ms, busy "
          f"{req.get('device_busy_ms')} ms; decode step wall median "
          f"{sa['step_ms_median']:.3f} ms, busy "
          f"{step.get('device_busy_ms')} ms, of it the plain cross "
          f"attention's {sa['cross_attention'].get('device_busy_ms')} ms; "
          f"downtimes {st['downtime_s']}; "
          f"peak device memory {peak} B; {wall:.1f} s")
    return {"arch": WHISPER_ARCH, "num_layers": L,
            "encoder_layers": cfg.encoder.num_layers, "splits": splits,
            "weight_bytes": nbytes, "stateless": st, "standalone": sa,
            "sharding": sh, "peak_device_bytes": peak, "wall_s": wall}


# ---------------------------------------------------------------------------
# phase 9: mixtral's windowed ring through the standalone functions
# ---------------------------------------------------------------------------

WINDOW_ARCH = "mixtral-8x22b"
WINDOW_LAYERS = 2          # of 56: 5.0 GB a layer in bf16 (281 GB in all)
WINDOW_PROMPT = 6144       # past the 4096 window, not a multiple of it
WINDOW_MAX_SEQ = 8192      # the ring: min(max_seq, window) = 4096 rows
WINDOW_STEPS = 16


def phase_window(K, seed, gclog: GcLog) -> dict:
    """mixtral-8x22b at full width, ``WINDOW_LAYERS`` layers, bf16, random
    weights from a seeded generator, routed without drops (capacity factor
    None: Mixtral routes every token to its top 2, and a capacity would
    drop prompt tokens that a one-token decode step keeps, so no full
    forward could be the oracle).  ``transformer.prefill`` over a
    ``WINDOW_PROMPT``-token prompt on the flash-attention kernel (window
    4096) into a 4096-row ring, then ``WINDOW_STEPS`` ``decode_step``s on
    the flash-decode kernel, the ring wrapping past row 2048.  Checks each
    kernel's launches (one a layer a prefill, one a layer a step), the
    ring's shape, and every logit row against the same run through the
    plain path (chunked attention, ``layers.decode_attention``) and
    against the windowed full forward over the same tokens (plain), each
    within ``LOGIT_RTOL`` of the largest logit."""
    from repro_torch.configs import get_config
    from repro_torch.core.stages import param_bytes
    from repro_torch.models import transformer as T

    gclog.label = f"{WINDOW_ARCH} phase 9"
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    base = get_config(WINDOW_ARCH)
    cfg = dataclasses.replace(base, num_layers=WINDOW_LAYERS,
                              moe=dataclasses.replace(base.moe,
                                                      capacity_factor=None))
    W, L, P, n = cfg.sliding_window, WINDOW_LAYERS, WINDOW_PROMPT, \
        WINDOW_STEPS
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = T.init_model(cfg, gen, dtype=torch.bfloat16, device="cuda")
    tg = torch.Generator().manual_seed(seed + 4)
    seq = torch.randint(0, cfg.vocab_size, (1, P + n), generator=tg).cuda()
    per_prefill = dict.fromkeys(K.wrappers, 0)
    per_prefill["flash_attention"] = L
    per_step = dict.fromkeys(K.wrappers, 0)
    per_step["flash_decode_attention"] = L

    def plain_path():
        out = []
        logits, cache = T.prefill(cfg, params, {"tokens": seq[:, :P]},
                                  max_seq=WINDOW_MAX_SEQ, attn_impl="chunked")
        out.append(logits)
        for i in range(n):
            logits, cache = T.decode_step(cfg, params,
                                          seq[:, P + i:P + i + 1], cache)
            out.append(logits)
        return torch.cat(out).float()

    # --- the main path, with the launch counts read around it ---------
    K.reset()
    t_main = time.perf_counter()
    before = K.read()
    logits, cache = T.prefill(cfg, params, {"tokens": seq[:, :P]},
                              max_seq=WINDOW_MAX_SEQ, attn_impl="kernel")
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t_main) * 1e3
    prefill_launches = K.since(before)
    got = [logits]
    steps = []
    for i in range(n):
        before = K.read()
        t = time.perf_counter()
        logits, cache = T.decode_step(cfg, params, seq[:, P + i:P + i + 1],
                                      cache, attn_impl="kernel")
        torch.cuda.synchronize()
        steps.append({"ms": (time.perf_counter() - t) * 1e3,
                      "launches": K.since(before)})
        got.append(logits)
    launches = K.read()
    got = torch.cat(got).float()
    check(prefill_launches == per_prefill, f"phase 9: the prefill launched "
                                           f"{prefill_launches}, want "
                                           f"{per_prefill}")
    check(all(st["launches"] == per_step for st in steps),
          f"phase 9: decode steps launched "
          f"{[st['launches'] for st in steps]}, want {per_step}")
    ring = tuple(cache["k"].shape)
    check(ring == (L, 1, cfg.num_kv_heads, W, cfg.head_dim)
          and int(cache["pos"]) == P + n,
          f"phase 9: ring {ring}, pos {int(cache['pos'])}")
    check(bool(torch.isfinite(got).all()), "phase 9: non-finite logits")
    step_ms = sorted(st["ms"] for st in steps)[n // 2]
    _, prof = profile_step(
        lambda: T.decode_step(cfg, params, seq[:, P + n - 1:P + n],
                              {k: (v.clone() if k != "pos" else v)
                               for k, v in cache.items()},
                              attn_impl="kernel")[0],
        request_bound_ms(cfg, params, 1), device_kernels(cfg))

    # --- the oracles: the plain path, and the windowed full forward ----
    plain = plain_path()
    h, _, _ = T.forward_hidden(cfg, params, {"tokens": seq},
                               attn_impl="chunked", window=W)
    full = (h[0, P - 1:] @ T.lm_head_weights(cfg, params)).float()
    del h
    scale = full.abs().max().item()
    d_plain = (got - plain).abs().max(-1).values.tolist()
    d_full = (got - full).abs().max(-1).values.tolist()
    limit = LOGIT_RTOL * scale
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    nbytes = param_bytes(params)
    print(f"[window] {WINDOW_ARCH}: {L} of {base.num_layers} layers, "
          f"d_model {cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads "
          f"of {cfg.head_dim}, {cfg.moe.num_experts} experts of "
          f"{cfg.moe.expert_d_ff} top-{cfg.moe.top_k}, window {W}, bf16, "
          f"{nbytes} B of weights; prompt {P}, max_seq {WINDOW_MAX_SEQ}, "
          f"ring {ring}; prefill {prefill_ms:.1f} ms launched "
          f"{prefill_launches}; {n} decode steps, median {step_ms:.3f} ms, "
          f"each launched {per_step}")
    print(f"[window] max |logit diff| by row (prefill, then each step) "
          f"against the plain path {d_plain}, against the windowed full "
          f"forward {d_full} (limit {limit:.3e} = {LOGIT_RTOL} of "
          f"{scale:.3e}); profiled step: {prof}; peak device memory {peak} "
          f"B; {wall:.1f} s")
    check(max(d_plain) <= limit, f"phase 9: logits differ from the plain "
                                 f"path by {max(d_plain)} (> {limit})")
    check(max(d_full) <= limit, f"phase 9: logits differ from the windowed "
                                f"full forward by {max(d_full)} (> {limit})")
    del params, cache
    free_memory()
    return {"arch": WINDOW_ARCH, "num_layers": L, "window": W,
            "prompt": P, "max_seq": WINDOW_MAX_SEQ, "ring": list(ring),
            "launches": launches, "launches_per_prefill": prefill_launches,
            "launches_per_step": per_step, "prefill_ms": prefill_ms,
            "step_ms": [st["ms"] for st in steps], "step_ms_median": step_ms,
            "profiled_step": prof, "weight_bytes": nbytes,
            "max_logit_diff_vs_plain": d_plain,
            "max_logit_diff_vs_windowed_forward": d_full,
            "logit_limit": limit, "peak_device_bytes": peak, "wall_s": wall}


# ---------------------------------------------------------------------------
# phase 11: training (qwen2.5-3b at full width and depth, f32)
# ---------------------------------------------------------------------------

TRAIN_ARCH = "qwen2.5-3b"
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = 20, 1, 2048, 3e-4
# the attention backward at qwen2.5-3b's training shape and at mixtral's
# window (phase 9's prompt): (B, S, H, KH, D, window), f32, causal
TRAIN_ATTN = {"qwen2.5-3b": (1, 2048, 16, 2, 128, None),
              "mixtral-8x22b window": (1, 6144, 48, 8, 128, 4096)}
# f32 gradients: 1e-4 of each one's largest |value|, the reference's f32
# attention tolerance
GRAD_RTOL = 1e-4
# the H100 SXM's FP32 rate outside the tensor cores (NVIDIA's data sheet):
# TF32 stays off, as phase 1 sets it
FP32_PEAK = 67e12
# the synthetic stream draws each batch's tokens from a fresh range of the
# 151936-token vocabulary, so 20 steps cannot lower its loss measurably:
# both packages stay within noise of their first loss there
# (tools/probe_stream_loss.py on the CPU; PERF.md).  So a correct step is
# shown on one batch repeated: over REPEAT_STEPS steps its loss must reach
# REPEAT_DROP nats below the first (at lr 3e-4 without a warm-up it falls
# unevenly: 12.35, 11.78, 11.00, 12.51, 10.01 on the card)
REPEAT_STEPS, REPEAT_DROP = 5, 0.5


def rel_err(got, want) -> float:
    return max_diff(got, want) / max(want.abs().max().item(), 1e-30)


def attention_grad_check(gen, B, S, H, KH, D, window) -> dict:
    """``attention(impl="chunked")``'s gradients (the blockwise backward,
    ``layers._ChunkedAttention``) against autograd through
    ``naive_attention``, one KV head's group of query heads at a time (the
    heads are independent; the full score tensor at mixtral's window would
    be 7.2 GB a copy).  Returns each one's error over its largest |value|
    and the device milliseconds of a forward and backward of each."""
    from repro_torch.models import layers as Lyr

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")
    q, k, v = rand(B, S, H, D), rand(B, S, KH, D), rand(B, S, KH, D)
    dout = rand(B, S, H, D)
    G = H // KH

    def function():
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = Lyr.attention(*leaves, causal=True, window=window,
                            impl="chunked")
        return [out.detach()] + list(torch.autograd.grad(out, leaves,
                                                         dout))

    def naive():
        parts = []
        for h in range(KH):
            hs = slice(h * G, (h + 1) * G)
            leaves = [t.detach().requires_grad_() for t in
                      (q[:, :, hs], k[:, :, h:h + 1], v[:, :, h:h + 1])]
            out = Lyr.naive_attention(*leaves, causal=True, window=window)
            parts.append([out.detach()] + list(torch.autograd.grad(
                out, leaves, dout[:, :, hs])))
        return [torch.cat([p[i] for p in parts], 2) for i in range(4)]
    got, want = function(), naive()
    errs = {name: rel_err(g, w) for name, g, w in
            zip(("out", "dq", "dk", "dv"), got, want)}
    del got, want
    return {"rel_err": errs,
            "ms": cuda_ms(lambda i: function(), 3),
            "naive_ms": cuda_ms(lambda i: naive(), 3)}


def ce_grad_check(cfg, gen) -> dict:
    """``chunked_cross_entropy``'s value and gradients (hidden and the
    tied head) at qwen2.5-3b's training shape against autograd through the
    whole ``(1, 2048, V)`` f32 logits (every 7th label ignored)."""
    from repro_torch.models import transformer as T
    S, V, D = TRAIN_SEQ, cfg.vocab_size, cfg.d_model
    hidden = torch.randn(1, S, D, generator=gen, device="cuda")
    embed = torch.randn(V, D, generator=gen, device="cuda") * 0.02
    labels = torch.randint(0, V, (1, S), generator=gen, device="cuda")
    labels[:, ::7] = -1

    def grads(loss_fn):
        h, e = (t.detach().requires_grad_() for t in (hidden, embed))
        loss = loss_fn(h, e)
        return [loss.detach()] + list(torch.autograd.grad(loss, (h, e)))

    def plain(h, e):
        logits = (h @ e.T).float()
        valid = labels >= 0
        nll = logits.logsumexp(-1) - logits.gather(
            -1, labels.clamp_min(0)[..., None])[..., 0]
        return (nll * valid).sum() / valid.sum()
    got = grads(lambda h, e: T.chunked_cross_entropy(cfg, {"embed": e}, h,
                                                     labels))
    want = grads(plain)
    return {"rel_err": {name: rel_err(g, w) for name, g, w in
                        zip(("loss", "d_hidden", "d_embed"), got, want)},
            "loss": got[0].item()}


def phase_training(K, seed, gclog: GcLog) -> dict:
    """(a) The attention backward at ``TRAIN_ATTN``'s shapes and (b) the
    loss's gradient, each against plain autograd; (c) ``train``, the
    port's loop, for qwen2.5-3b at full width and depth: f32 weights and
    AdamW state, ``TRAIN_STEPS`` steps of batch ``TRAIN_BATCH`` and
    ``TRAIN_SEQ`` tokens, ``remat``; the last step under torch.profiler;
    (d) ``make_train_step`` with ``train``'s initialisation and optimizer
    on the stream's first batch, repeated ``REPEAT_STEPS`` times.  Checks
    finite losses, the first within 1.5 nats above ln V, the repeated
    batch's loss reaching ``REPEAT_DROP`` nats below its first, and that
    none of the four kernels launched (they have no backward: the
    training route is plain)."""
    import statistics
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokens
    from repro_torch.models.transformer import init_model
    from repro_torch.optim import adamw, cosine_schedule
    from repro_torch.training import make_train_step, train

    t0 = time.perf_counter()
    gclog.label = "phase 11"
    cfg = get_config(TRAIN_ARCH)
    gen = torch.Generator(device="cuda").manual_seed(seed + 11)
    K.reset()
    checks = {name: attention_grad_check(gen, *shape)
              for name, shape in TRAIN_ATTN.items()}
    free_memory()
    checks["cross_entropy"] = ce_grad_check(cfg, gen)
    free_memory()
    for name, c in checks.items():
        print(f"[train] {name}: gradients over plain autograd, error / "
              f"largest |value|: {c['rel_err']}"
              + (f"; forward + backward {c['ms']:.3f} ms, plain "
                 f"{c['naive_ms']:.3f} ms" if "ms" in c else ""))
        for part, err in c["rel_err"].items():
            check(err <= GRAD_RTOL, f"phase 11 {name}: {part} off by {err} "
                                    f"of its largest value (> {GRAD_RTOL})")
    check(K.read() == dict.fromkeys(K.wrappers, 0),
          f"phase 11's gradient checks launched {K.read()}")

    # --- (c) the training run, with the launch counts read around it ---
    torch.cuda.reset_peak_memory_stats()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   schedule=schedule(wait=TRAIN_STEPS - 2, warmup=1,
                                     active=1))
    lines = []

    def log(line):
        lines.append(line)
        prof.step()
    K.reset()
    sw = time.perf_counter()
    with prof:
        hist = train(cfg, steps=TRAIN_STEPS, batch=TRAIN_BATCH,
                     seq=TRAIN_SEQ, lr=TRAIN_LR, seed=seed, log_every=1,
                     remat=True, log_fn=log)
    run_s = time.perf_counter() - sw
    peak = torch.cuda.max_memory_allocated()
    free_memory()

    # --- (d) the stream's first batch, repeated ---------------------------
    params = init_model(cfg, torch.Generator(device="cuda").manual_seed(seed),
                        device="cuda")
    step, init_opt = make_train_step(cfg, optimizer=adamw(
        schedule=cosine_schedule(TRAIN_LR, warmup=max(TRAIN_STEPS // 20, 1),
                                 total=TRAIN_STEPS)), remat=True)
    opt = init_opt(params)
    first = next(iter(SyntheticTokens(cfg, TRAIN_BATCH, TRAIN_SEQ,
                                      seed=seed)))
    batch = {k: torch.from_numpy(v).cuda() for k, v in first.items()}
    repeat = []
    for _ in range(REPEAT_STEPS):
        params, opt, metrics = step(params, opt, batch)
        repeat.append(metrics["loss"].item())
    del params, opt, metrics, step
    launches = K.read()
    losses, walls = hist["loss"], hist["step_time"]
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and not e.is_user_annotation and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    gemm_ms = sum(e.self_device_time_total for e in events
                  if "gemm" in e.key.lower()) / 1e3
    top = sorted(events, key=lambda e: e.self_device_time_total,
                 reverse=True)[:5]
    prof_wall_ms = walls[-1] * 1e3
    med = statistics.median(walls[1:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    n_params = cfg.param_count()
    flops = 6 * n_params * tokens
    out = {"arch": TRAIN_ARCH, "steps": TRAIN_STEPS, "batch": TRAIN_BATCH,
           "seq": TRAIN_SEQ, "lr": TRAIN_LR, "losses": losses,
           "step_s": walls, "step_s_median_2_on": med,
           "tokens_per_s": tokens / med, "param_count": n_params,
           "model_flops_per_s": flops / med,
           "fp32_peak_share": flops / med / FP32_PEAK,
           "peak_device_bytes": peak, "launches": launches,
           "repeated_batch_losses": repeat,
           "first_five_mean": statistics.mean(losses[:5]),
           "last_five_mean": statistics.mean(losses[-5:]),
           "profiled_step": {
               "wall_ms": prof_wall_ms, "device_busy_ms": busy_ms,
               "idle_share": max(0.0, 1.0 - busy_ms / prof_wall_ms),
               "gemm_ms": gemm_ms,
               "device_ops": sum(e.count for e in events),
               "top_device_ms": {e.key[:70]: e.self_device_time_total / 1e3
                                 for e in top}},
           "gradient_checks": checks, "run_s": run_s}
    print(f"[train] {TRAIN_ARCH}: {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {n_params} params (param_count), f32 weights and "
          f"AdamW state, remat; {TRAIN_STEPS} steps of {TRAIN_BATCH} x "
          f"{TRAIN_SEQ} tokens at lr {TRAIN_LR}; the loop's log {lines}")
    ln_v = math.log(cfg.vocab_size)
    print(f"[train] first loss {losses[0]:.4f} against ln V {ln_v:.4f}; "
          f"losses {losses}; mean of the first five "
          f"{out['first_five_mean']:.4f}, of the last five "
          f"{out['last_five_mean']:.4f}; the first batch repeated "
          f"{REPEAT_STEPS} times: losses {repeat}")
    print(f"[train] step wall median over steps 2-{TRAIN_STEPS} {med:.4f} s "
          f"({tokens / med:.1f} tokens/s); model FLOP/s (6 N T) "
          f"{flops / med:.4e}, {flops / med / FP32_PEAK:.4f} of the FP32 "
          f"peak {FP32_PEAK:.3e}; peak device memory {peak} B; the run "
          f"{run_s:.1f} s")
    print(f"[train] profiled step {TRAIN_STEPS}: {out['profiled_step']}")
    print(f"[train] kernel launches on the training path: {launches} (none "
          f"of the four has a backward; the path runs the plain routes)")
    check(all(math.isfinite(x) for x in losses),
          f"phase 11: non-finite losses {losses}")
    check(ln_v <= losses[0] <= ln_v + 1.5,
          f"phase 11: first loss {losses[0]}, want within 1.5 nats above "
          f"ln V {ln_v}")
    check(all(math.isfinite(x) for x in repeat)
          and min(repeat[1:]) <= repeat[0] - REPEAT_DROP,
          f"phase 11: one batch repeated {REPEAT_STEPS} times, losses "
          f"{repeat}: want one {REPEAT_DROP} nats below the first")
    check(launches == dict.fromkeys(K.wrappers, 0),
          f"phase 11: the training path launched {launches}, want none")
    check(busy_ms > 0, "phase 11: the profiled step shows no device time")
    free_memory()
    out["wall_s"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# phase 13: the dry run on the meta device, and the op counter on the card
# ---------------------------------------------------------------------------

COUNT_ARCH = "qwen2.5-3b"
DRYRUN_SHAPES = ("train_4k", "prefill_32k", "decode_32k")
COUNT_REPS = 10                     # unprofiled calls, the median taken


def phase_dryrun() -> dict:
    """13a: ``launch.dryrun``'s count of ``COUNT_ARCH`` at each of
    ``DRYRUN_SHAPES`` on the 16 x 16 production mesh, in this process on
    meta tensors (nothing on the card), priced on the H100 spec; prints
    the three terms and checks each finite and the step's flops and
    bytes positive."""
    from repro_torch.launch.dryrun import analyse, count_pair

    t0 = time.perf_counter()
    out = {}
    for name in DRYRUN_SHAPES:
        meta = count_pair(COUNT_ARCH, name, multi_pod=False)
        rl = analyse(COUNT_ARCH, name, meta)
        terms = (rl.t_compute, rl.t_memory, rl.t_collective)
        check(rl.hlo_flops > 0 and rl.hlo_bytes > 0
              and all(math.isfinite(t) and t > 0 for t in terms),
              f"dry run {COUNT_ARCH} {name}: flops {rl.hlo_flops}, bytes "
              f"{rl.hlo_bytes}, terms {terms}")
        out[name] = {"t_compute_ms": rl.t_compute * 1e3,
                     "t_memory_ms": rl.t_memory * 1e3,
                     "t_collective_ms": rl.t_collective * 1e3,
                     "bottleneck": rl.bottleneck,
                     "useful_flops_frac": rl.useful_flops_frac,
                     "per_device_bytes": rl.per_device_bytes,
                     "device_spec": rl.device_spec,
                     "count_s": meta["count_s"]}
        print(f"[dryrun] {COUNT_ARCH} {name} on {rl.mesh} ({rl.chips} "
              f"chips, {rl.device_spec}): compute "
              f"{out[name]['t_compute_ms']:.3f} ms, memory "
              f"{out[name]['t_memory_ms']:.3f} ms, collective "
              f"{out[name]['t_collective_ms']:.3f} ms [{rl.bottleneck}]; "
              f"model flops / counted {rl.useful_flops_frac:.3f}; "
              f"{(rl.per_device_bytes or 0) / 2 ** 30:.2f} GiB a device; "
              f"counted in {meta['count_s']:.1f} s")
    out["wall_s"] = time.perf_counter() - t0
    print(f"[dryrun] phase 13a took {out['wall_s']:.1f} s")
    return out


def phase_counter(K: Counts, cfg, params, seed: int) -> dict:
    """13b: ``distributed.op_analysis``'s counter around ``COUNT_ARCH``'s
    full-width decode step (against the cache of phase 6's 1024-token
    request, ``max_seq`` ``MAX_SEQ``) and around that request through
    every unit, both on the kernel route, on the weights phases 4-6
    loaded.  Checks, for each: the counter saw exactly as many calls of
    each kernel as its launch counter rose by, the counted bytes are at
    least the weights' (each read once), the counted flops are positive
    and the logits finite.  Prints the counted flops and bytes, their
    ratio to ``model_flops_estimate``, the counted bound beside
    ``request_bound_ms``'s, and ``kernel_roofline`` of the profiled busy
    time and of the unprofiled median wall against the H100."""
    from repro_torch.configs.base import InputShape
    from repro_torch.core.hardware import H100
    from repro_torch.core.stages import StageRunner, tree_leaves
    from repro_torch.distributed.op_analysis import OpCounter
    from repro_torch.distributed.roofline import (kernel_roofline,
                                                  model_flops_estimate)
    from repro_torch.models import transformer as T

    t0 = time.perf_counter()
    prompt = stateless_request(cfg, seed + 2)
    rows = prompt["tokens"].shape[1]
    weights = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    runner = StageRunner(cfg, params, attn_impl="kernel", device="cuda")
    full = runner.stage_executable(0, runner.num_units, params, prompt)
    _, cache = T.prefill(cfg, params, prompt, max_seq=MAX_SEQ,
                         attn_impl="kernel")
    token = prompt["tokens"][:, -1:]
    pos = int(cache["pos"])
    calls = {
        "decode_step": (lambda: T.decode_step(cfg, params, token, cache,
                                              attn_impl="kernel")[0],
                        InputShape("step", MAX_SEQ, 1, "decode"),
                        request_bound_ms(cfg, params, 1, extra_bytes=sum(
                            cache[k][:, :, :, :pos + 1].numel()
                            * cache[k].element_size() for k in ("k", "v")))),
        "request": (lambda: full(params, prompt)["logits"],
                    InputShape("request", rows, 1, "prefill"),
                    request_bound_ms(cfg, params, rows,
                                     attention_flops(cfg, rows,
                                                     cfg.num_layers)))}
    out = {}
    for name, (fn, shape, hand_ms) in calls.items():
        fn()                                    # warm
        torch.cuda.synchronize()
        before = K.read()
        with OpCounter() as c:
            logits = fn()
        torch.cuda.synchronize()
        launched = {k: v for k, v in K.since(before).items() if v}
        tot = c.totals()
        check(tot["kernel_calls"] == launched,
              f"13b {name}: the counter saw kernel calls "
              f"{tot['kernel_calls']}, the launch counters rose by "
              f"{launched}")
        check(tot["bytes"] >= weights, f"13b {name}: counted bytes "
              f"{tot['bytes']} under the weights' {weights}")
        check(tot["flops"] > 0, f"13b {name}: counted no flops")
        check(bool(torch.isfinite(logits).all()),
              f"13b {name}: non-finite logits")
        walls = []
        for _ in range(COUNT_REPS):
            torch.cuda.synchronize()
            w0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - w0)
        wall = sorted(walls)[len(walls) // 2]
        _, prof = profile_step(fn, hand_ms, device_kernels(cfg))
        busy = prof.get("device_busy_ms")
        check(busy is not None and busy > 0,
              f"13b {name}: the profiler read no device time: {prof}")
        cost = {"flops": tot["flops"], "bytes accessed": tot["bytes"]}
        kr_busy = kernel_roofline(f"{name} busy", wall_s=busy / 1e3,
                                  cost=cost)
        kr_wall = kernel_roofline(f"{name} wall", wall_s=wall, cost=cost)
        mf = model_flops_estimate(cfg, shape)
        bound_ms = max(tot["flops"] / H100.flops,
                       tot["bytes"] / H100.hbm_bw) * 1e3
        out[name] = {"counted": {k: tot[k] for k in (
            "flops", "bytes", "ops", "kernel_calls", "kernel_flops",
            "kernel_bytes", "peak_live_bytes")},
            "launched": launched, "weights_bytes": weights,
            "model_flops": mf, "flops_over_model": tot["flops"] / mf,
            "counted_bound_ms": bound_ms, "hand_bound_ms": hand_ms,
            "wall_ms": wall * 1e3, "busy_ms": busy,
            "roofline_busy": kr_busy.to_dict(),
            "roofline_wall": kr_wall.to_dict()}
        print(f"[counter] {cfg.name} {name} ({rows} rows, pos {pos}): "
              f"counted {tot['flops']:.4e} flops, {tot['bytes']:.4e} B "
              f"over {tot['ops']} operators (weights {weights} B), kernel "
              f"calls {tot['kernel_calls']} = launches; flops over "
              f"model_flops_estimate {tot['flops'] / mf:.4f}; counted "
              f"bound {bound_ms:.4f} ms beside the hand-computed "
              f"{hand_ms:.4f}; busy {busy:.3f} ms: "
              f"{kr_busy.flops_frac:.4f} of the bf16 peak, "
              f"{kr_busy.bw_frac:.4f} of HBM [{kr_busy.bound}]; "
              f"unprofiled median wall {wall * 1e3:.3f} ms: "
              f"{kr_wall.flops_frac:.4f}, {kr_wall.bw_frac:.4f}")
    del cache, runner, full
    out["wall_s"] = time.perf_counter() - t0
    print(f"[counter] phase 13b took {out['wall_s']:.1f} s")
    return out


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

    # phases 4-6: each model's stateful and stateless paths; phases 7
    # and 12, qwen2.5-3b's serving stream and its sharded cloud stage
    models = [run_model(K, arch, args.seed, gclog) for arch in MODELS]
    # phase 8: the paper's own CNNs at 224 px
    cnns = [phase_cnn(K, arch, args.seed, gclog) for arch in CNN_ARCHS]
    # phase 9: mixtral's windowed ring through the standalone functions
    window = phase_window(K, args.seed, gclog)
    # phase 10: whisper-medium at full depth
    whisper = phase_whisper(K, args.seed, gclog)
    # phase 11: training qwen2.5-3b
    training = phase_training(K, args.seed, gclog)
    # phase 13a: the dry run on the meta device (13b ran with phase 4-6's
    # qwen2.5-3b)
    gclog.label = "phase 13a"
    dryrun = phase_dryrun()
    check("jax" not in sys.modules, "the port imported jax")
    paths = [(f"{m['arch']} {path}", m[path]["launches"])
             for m in models + [whisper]
             for path in ("stateful", "stateless", "serving", "standalone",
                          "sharding")
             if path in m]
    paths.append((f"{WINDOW_ARCH} window", window["launches"]))
    for name, row in rows.items():
        by_path = {path: n[name] for path, n in paths if n[name]}
        row["launches"] = sum(by_path.values())
        row["launches_by_path"] = by_path
        check(row["launches"] > 0, f"{name} never launched on a main path")

    # phase 14: report
    wall = time.perf_counter() - t_start
    print(f"[done] the whole script took {wall:.1f} s; garbage "
          f"collections {gclog.summary()}; flash_decode device-time traces "
          f"{DECODE_TRACES}")
    print(json.dumps({"kernels": list(rows.values()), "build_s": t_build,
                      "wall_s": wall, "decode_traces": DECODE_TRACES,
                      "models": models, "cnn": cnns, "window": window,
                      "whisper": whisper, "training": training,
                      "dryrun": dryrun}))

    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
