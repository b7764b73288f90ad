"""Time the flash-decode kernel on the card at its served shapes under
several grid plans, and read one full-width qwen2.5-3b decode step.

    python3 tools/probe_flash_decode.py [--targets 64,128,256]
        [--row-tiles 2,4] [--pos 64,1024,2048] [--step] [--steps N]
        [--copy] [--src DIR]

For each ``TARGET_BLOCKS`` in ``--targets`` (the blocks a call aims at,
``kernels/flash_decode.py:split_plan``), each ``MAX_ROW_TILE`` in
``--row-tiles`` (query heads a block) and each served decode shape
(qwen2.5-3b: 16 / 2 heads of 128; zamba2-7b's shared attention: 32 / 32
heads of 112; bf16, ``max_seq`` 2048): the kernel's device time a call at
every ``--pos`` (torch.profiler, chip_smoke.py's ``decode_device_us``,
caches rotated out of L2) and its CUDA-event time at pos 1024.  With
``--step``, ``--steps`` (3) qwen2.5-3b decode steps (full width, bf16,
random weights, prompt 1024), each under torch.profiler: device ops
(kernels and copies), aten operators, busy time, the flash-decode
kernels' device time a call, their traced launches beside the wrapper's
count, the kernel launches the host made beside the records traced, and
a hash of the step's logits (equal hashes across trees: bit-equal).
With ``--copy``, the card's device-memory rate at zamba2-7b's size: a
plain ``Tensor.copy_`` of the bytes a call reads at pos 1024 (14.7 MB),
CUDA events, rotated out of L2.
``--src DIR`` imports the port from ``DIR/src`` instead of this checkout,
so that a parent tree is read by the same probe (its kernel timing is
skipped).  Prints a JSON line a reading.  Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SHAPES = {"qwen2.5-3b": dict(B=1, H=16, KH=2, S=2048, D=128),
          "zamba2-7b": dict(B=1, H=32, KH=32, S=2048, D=112)}
STEP_KEYS = ("flash_decode_kernel", "decode_split_kernel",
             "decode_combine_kernel")


def time_plans(CS, FD, targets, tiles, positions, seed: int) -> None:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for name, sh in SHAPES.items():
        B, H, KH, S, D = (sh[k] for k in ("B", "H", "KH", "S", "D"))
        n = max(2, -(-128 * 2 ** 20 // (4 * B * KH * S * D)))

        def rand(shape):
            return torch.randn(shape, generator=gen, device="cuda",
                               dtype=torch.bfloat16)
        qs = [rand((B, 1, H, D)) for _ in range(n)]
        ks = [rand((B, KH, S, D)) for _ in range(n)]
        vs = [rand((B, KH, S, D)) for _ in range(n)]
        pos_t = torch.tensor(1024, dtype=torch.int32, device="cuda")
        for target in targets:
            for tile in tiles:
                FD.TARGET_BLOCKS, FD.MAX_ROW_TILE = target, tile
                GT, RG = FD.row_tile(H // KH)
                device_us = {p: CS.decode_device_us(FD, qs, ks, vs, p)
                             for p in positions}
                ms = CS.cuda_ms(lambda i: FD.flash_decode_attention(
                    qs[i % n], ks[i % n], vs[i % n], pos=pos_t), 200)
                print(json.dumps({
                    "shape": name, "target_blocks": target, "row_tile": GT,
                    "n_split": FD.split_plan(B, KH, S, RG),
                    "device_us_per_call": device_us,
                    "event_ms_pos1024": ms}), flush=True)


def read_step(CS, FD, seed: int, steps: int) -> None:
    from repro_torch.configs import get_config
    from repro_torch.core.network import NetworkModel
    from repro_torch.core.stateful import make_stateful_manager
    from repro_torch.models.transformer import init_model

    cfg = get_config("qwen2.5-3b")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = init_model(cfg, gen, dtype=torch.bfloat16, device="cuda")
    mgr, _ = make_stateful_manager(
        cfg, params, split=cfg.num_layers // 2, net=NetworkModel(20.0),
        prompt_len=CS.PROMPT, max_seq=CS.MAX_SEQ, seed=seed,
        decode_impl="auto", attn_impl="kernel", device="cuda")
    for _ in range(8):
        mgr.serve(None)
    bound = CS.request_bound_ms(cfg, params, 1)
    for i in range(steps):
        n0 = FD.flash_decode_attention.launches
        logits, prof = CS.profile_step(lambda: mgr.serve(None)[0], bound,
                                       STEP_KEYS)
        keep = ("device_busy_ms", "idle_share", "device_ops", "aten_ops",
                "kernel_calls", "kernel_device_us_per_launch",
                "kernel_device_ms", "kernel_launches_vs_records")
        print(json.dumps({
            "step": i, **{k: prof.get(k) for k in keep},
            "wrapper_launches": FD.flash_decode_attention.launches - n0,
            "logits_sha256": hashlib.sha256(
                logits.float().cpu().numpy().tobytes()).hexdigest()[:16]}),
            flush=True)
    CS.shut(mgr)


def copy_rate(CS) -> None:
    nbytes = 2 * 32 * 1024 * 112 * 2         # zamba2-7b's K and V, pos 1024
    srcs = [torch.empty(nbytes // 2, dtype=torch.bfloat16, device="cuda")
            for _ in range(8)]
    dsts = [torch.empty_like(t) for t in srcs]
    ms = CS.cuda_ms(lambda i: dsts[i % 8].copy_(srcs[(i + 3) % 8]), 200)
    print(json.dumps({"copy_bytes": nbytes, "copy_ms": ms,
                      "read_plus_write_TBps": 2 * nbytes / ms / 1e9}),
          flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--targets", default="")
    ap.add_argument("--row-tiles", default="")
    ap.add_argument("--pos", default="64,1024,2048")
    ap.add_argument("--step", action="store_true")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--copy", action="store_true")
    ap.add_argument("--src", default=ROOT)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path[:0] = [os.path.join(os.path.abspath(args.src), "src"), ROOT]
    import chip_smoke as CS
    if not torch.cuda.is_available():
        CS.fail("no CUDA device")
    from repro_torch.kernels import flash_decode as FD
    print(CS.smi_line())
    print(json.dumps({"port": os.path.dirname(FD.__file__)}))
    if os.path.abspath(args.src) == ROOT:
        targets = [int(t) for t in args.targets.split(",") if t] \
            or [FD.TARGET_BLOCKS]
        tiles = [int(t) for t in args.row_tiles.split(",") if t] \
            or [FD.MAX_ROW_TILE]
        positions = [int(p) for p in args.pos.split(",") if p]
        time_plans(CS, FD, targets, tiles, positions, args.seed)
    if args.copy:
        copy_rate(CS)
    if args.step:
        read_step(CS, FD, args.seed, args.steps)


if __name__ == "__main__":
    main()
