"""Repeat one model's stateful switches on the card and read every one
with chip_smoke.py's switch probe: how often a switch's state hand-off
runs long, and what the host and the device read when it did.

    python3 tools/probe_switches.py [--arch falcon-mamba-7b] [--rounds 40]
        [--empty-cache] [--record-allocs] [--src DIR] [--after ARCH,...]

The model is built as chip_smoke.py's phase 4 builds it (full width, at
its ``DEPTH`` where that cuts it,
bf16, random weights from ``--seed``, prompt 1024, ``max_seq`` 2048, the
kernels, 16 decode steps, then a 5 Mbps link). Each round is phase 4's
first two switches: switch_b2 from half to a quarter of the depth, 8
steps, ``build_standby`` at half, switch_a back, 8 steps.
``--empty-cache`` calls ``torch.cuda.empty_cache()`` before switch_b2
and before the standby's build, so a hand-off whose working set no build
left in the cache makes fresh ``cudaMalloc``s. Prints a JSON line a
switch (``probe``) and, last, a summary: each strategy's hand-off walls,
the switches whose hand-off took more than twice that strategy's
median, and the caching allocator's peak allocated and reserved bytes. switch_a runs with the pool's build worker held
(``chip_smoke.builds_held``), so its allocator counters are the switch's
own. ``--record-allocs`` records the caching allocator's history
(``torch.cuda.memory._record_memory_history``) from each standby build
to the end of the switch after it and prints, per switch, every
``cudaMalloc`` (segment allocation) after the build with its size,
stream and the port's frames that asked for it. ``--src DIR`` imports
the port from ``DIR/src`` instead of this checkout (another tree, e.g.
a parent commit unpacked beside this one). ``--after`` first runs
chip_smoke.py's phases 4-6 (``run_model``, phase 7 too for qwen2.5-3b)
for each listed model, so the probed model meets the caching allocator
as the script leaves it for that model's phase 4. Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import statistics
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import chip_smoke as CS  # noqa: E402


def segment_allocs(snapshot: dict, since: int) -> list:
    """``cudaMalloc``s (``segment_alloc`` trace entries) recorded after
    trace index ``since``: size, stream and the innermost frames of the
    port, the script and the tools that asked for them."""
    out = []
    for trace in snapshot["device_traces"]:
        for e in trace[since:]:
            if e["action"] != "segment_alloc":
                continue
            frames = [f"{os.path.basename(f['filename'])}:{f['line']} "
                      f"{f['name']}" for f in e.get("frames", [])
                      if "repro_torch" in f["filename"]
                      or "chip_smoke" in f["filename"]
                      or "probe_" in f["filename"]][:6]
            out.append({"bytes": e["size"], "stream": e["stream"],
                        "frames": frames})
    return out


def trace_len() -> int:
    return sum(len(t) for t in torch.cuda.memory._snapshot()
               ["device_traces"])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="falcon-mamba-7b")
    ap.add_argument("--rounds", type=int, default=40)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--empty-cache", action="store_true")
    ap.add_argument("--record-allocs", action="store_true")
    ap.add_argument("--src", default=ROOT)
    ap.add_argument("--after", default="",
                    help="comma-separated models whose chip_smoke.py "
                         "phases 4-6 run first")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        CS.fail("no CUDA device")
    sys.path.insert(0, os.path.join(os.path.abspath(args.src), "src"))
    from repro_torch.configs import get_config
    from repro_torch.core.network import NetworkModel
    from repro_torch.core.stateful import make_stateful_manager
    from repro_torch.models.transformer import init_model

    print(CS.smi_line())
    gclog = CS.GcLog()
    if args.after:
        from repro_torch.kernels import flash_attention as FA
        from repro_torch.kernels import flash_decode as FD
        from repro_torch.kernels import mamba_scan as MS
        from repro_torch.kernels import ssd_scan as SD
        K = CS.Counts({"flash_decode_attention": FD.flash_decode_attention,
                       "flash_attention": FA.flash_attention,
                       "mamba1_scan": MS.mamba1_scan, "ssd_scan": SD.ssd_scan})
        torch.backends.cuda.matmul.allow_tf32 = False   # as the script
        torch.backends.cudnn.allow_tf32 = False
        for arch in args.after.split(","):
            CS.run_model(K, arch, args.seed, gclog)
        torch.cuda.reset_peak_memory_stats()   # the probed model's own
    gclog.label = f"{args.arch} switches"
    cfg = get_config(args.arch)
    if args.arch in CS.DEPTH:              # cut for memory as chip_smoke's
        cfg = dataclasses.replace(cfg, num_layers=CS.DEPTH[args.arch])
    L = cfg.num_layers
    half, quarter = L // 2, L // 4
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    params = init_model(cfg, gen, dtype=torch.bfloat16, device="cuda")
    mgr, session = make_stateful_manager(
        cfg, params, split=half, net=NetworkModel(20.0),
        prompt_len=CS.PROMPT, max_seq=CS.MAX_SEQ, seed=args.seed,
        decode_impl="auto", attn_impl="kernel", device="cuda")
    # the stream's length is bounded by max_seq: 16 + 16 steps a round
    rounds = min(args.rounds, (CS.MAX_SEQ - CS.PROMPT - 16) // 16)

    def serve(n):
        for _ in range(n):
            mgr.serve(None)
        torch.cuda.synchronize()

    walls = {"switch_b2": [], "switch_a": []}
    probes = []
    serve(16)
    mgr.set_network(NetworkModel(5.0))
    t0 = time.perf_counter()
    for r in range(rounds):
        for strategy, split in (("switch_b2", quarter), ("switch_a", half)):
            if args.empty_cache:
                torch.cuda.empty_cache()
            since = None
            if strategy == "switch_a":
                if args.record_allocs:
                    torch.cuda.memory._record_memory_history(
                        stacks="python", max_entries=1_000_000)
                mgr.build_standby(half)
                if args.record_allocs:
                    since = trace_len()
            held = CS.builds_held(mgr) if strategy == "switch_a" \
                else contextlib.nullcontext()
            with held, CS.switch_probe(mgr, session, gclog) as probe:
                rep = mgr.repartition(strategy, split)
            probe.update(round=r, strategy=strategy,
                         downtime_s=rep.downtime, handoff=rep.handoff_mode,
                         handoff_s=rep.t_handoff)
            if since is not None:
                probe["segment_allocs"] = segment_allocs(
                    torch.cuda.memory._snapshot(), since)
                torch.cuda.memory._record_memory_history(enabled=None)
            walls[strategy].append(rep.t_handoff)
            probes.append(probe)
            print(json.dumps({"probe": probe}, default=str), flush=True)
            serve(8)
    wall = time.perf_counter() - t0
    CS.shut(mgr)
    long = []
    for strategy, ws in walls.items():
        med = statistics.median(ws)
        long += [p for p in probes if p["strategy"] == strategy
                 and p["handoff_s"] > 2 * med]
    print(json.dumps({"arch": args.arch, "rounds": rounds,
                      "src": os.path.abspath(args.src),
                      "empty_cache": args.empty_cache, "wall_s": wall,
                      "handoff_s": walls,
                      "median_s": {k: statistics.median(v)
                                   for k, v in walls.items()},
                      "long": long, "gc": gclog.summary(),
                      "max_memory_allocated": torch.cuda.max_memory_allocated(),
                      "max_memory_reserved": torch.cuda.max_memory_reserved()},
                     default=str))


if __name__ == "__main__":
    main()
