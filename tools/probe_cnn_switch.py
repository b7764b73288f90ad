"""Rerun chip_smoke.py's phase-8c stream of one CNN under one strategy
many times on the card, and read every forward of it: where a switch
drop comes from.

    python3 tools/probe_cnn_switch.py [--arch vgg19] [--strategy switch_a]
        [--repeats 12] [--seed 0] [--profile-once]
        [--variants phase,unreserved] [--out FILE]

Each repeat measures the profile again (phase 8b's ``profile_cnn`` under
both pricings; ``--profile-once`` keeps the first), runs the stream as
phase 8c does (``chip_smoke.cnn_stream``) and records, for every
``EdgeCloudPipeline.process`` call: its thread, host start and wall, the
measured ``t_edge``/``t_transfer``/``t_cloud``, the request it served
(arrival on the stream clock, edge start), the pool's pending builds at
its start, the build jobs that overlapped it on the worker, the caching
allocator's ``cudaMalloc``s across it and the garbage collections inside
it, its thread CPU time and the host's stolen time.  Every drop is
printed with its window and the forward before it.  ``--variants`` takes
the listed ways of driving the stream in turn, one a repeat.
Prints one JSON line a repeat and a summary last, and appends every
repeat's full readings to ``--out``.  Needs one CUDA card and builds no
kernel.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile
import threading
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import chip_smoke as CS  # noqa: E402


class Recorder:
    """The forwards and build jobs of one stream, on ``perf_counter``."""

    def __init__(self, gclog: CS.GcLog):
        self.gclog = gclog
        self.forwards, self.builds = [], []
        self.current = threading.local()
        self.mgr = None

    def hook(self, mgr) -> None:
        """``cnn_stream``'s ``on_manager``: time every build job."""
        self.mgr = mgr
        ex = mgr.pool.executor
        real = ex.submit
        builds = self.builds

        def submit(fn, **kw):
            def job():
                rec = {"key": str(kw.get("key")), "t0": time.perf_counter(),
                       "c0": time.thread_time(),
                       "mallocs": torch.cuda.memory_stats().get(
                           "num_device_alloc", 0)}
                try:
                    out = fn()
                    rep = getattr(out, "report", None)
                    rec["report"] = None if rep is None else {
                        k: v for k, v in vars(rep).items()
                        if isinstance(v, (int, float))}
                    return out
                finally:
                    rec["t1"] = time.perf_counter()
                    rec["cpu_s"] = time.thread_time() - rec["c0"]
                    rec["mallocs"] = torch.cuda.memory_stats().get(
                        "num_device_alloc", 0) - rec["mallocs"]
                    builds.append(rec)
            return real(job, **kw)
        ex.submit = submit

    @contextlib.contextmanager
    def recording(self):
        from repro_torch.core.pipeline import EdgeCloudPipeline
        from repro_torch.serving.engine import ServingEngine
        real_process = EdgeCloudPipeline.process
        real_execute = ServingEngine._execute
        rec_self = self

        def process(pipe, inputs, **kw):
            mem0 = torch.cuda.memory_stats()
            pend = rec_self.mgr.pool.pending_builds() \
                if rec_self.mgr is not None else None
            h0 = CS.host_counters()
            c0, t0 = time.thread_time(), time.perf_counter()
            out = real_process(pipe, inputs, **kw)
            t1, c1 = time.perf_counter(), time.thread_time()
            host = CS.host_delta(h0, CS.host_counters())
            mem1 = torch.cuda.memory_stats()
            req = getattr(rec_self.current, "req", None)
            rec_self.current.req = None
            tm = out[1]
            rec_self.forwards.append({
                "thread": threading.current_thread().name,
                "t0": t0, "t1": t1, "split": pipe.split,
                "mbps": pipe.net.bandwidth_mbps,
                "t_edge": tm.t_edge, "t_transfer": tm.t_transfer,
                "t_cloud": tm.t_cloud, "pending_builds": pend,
                "mallocs": mem1.get("num_device_alloc", 0)
                - mem0.get("num_device_alloc", 0),
                "alloc": {k: mem1.get(k, 0) - mem0.get(k, 0)
                          for k in CS.ALLOC_KEYS},
                "cpu_s": c1 - c0, "steal_s": host["steal_s"],
                "gc": rec_self.gclog.between(t0, t1),
                "request": req})
            return out

        def execute(eng, rec, inputs, start):
            rec_self.current.req = {"rid": rec.rid, "arrival": rec.t_arrival,
                                    "start": start}
            return real_execute(eng, rec, inputs, start)

        EdgeCloudPipeline.process = process
        ServingEngine._execute = execute
        try:
            yield self
        finally:
            EdgeCloudPipeline.process = real_process
            ServingEngine._execute = real_execute

    def overlapping(self, f) -> list:
        """Build jobs whose span meets forward ``f``'s, as (key, seconds of
        overlap)."""
        out = []
        for b in self.builds:
            lo, hi = max(f["t0"], b["t0"]), min(f["t1"], b["t1"])
            if hi > lo:
                out.append((b["key"], round(hi - lo, 6)))
        return out


def readings(rec: Recorder, tl, origin: float) -> dict:
    """The stream's forwards on the serving thread, its drops and the
    forward that held the edge at each drop."""
    main = [f for f in rec.forwards if f["request"] is not None]
    for f in main:
        f["builds"] = rec.overlapping(f)
        f["wall"] = f["t1"] - f["t0"]
    rows = []
    for f in main:
        r = f["request"]
        rows.append({"rid": r["rid"], "arrival": r["arrival"],
                     "start": r["start"], "split": f["split"],
                     "mbps": f["mbps"],
                     "host_wall_ms": f["wall"] * 1e3,
                     "t_edge_ms": f["t_edge"] * 1e3,
                     "t_transfer_ms": f["t_transfer"] * 1e3,
                     "t_cloud_ms": f["t_cloud"] * 1e3,
                     "pending_builds": f["pending_builds"],
                     "builds": f["builds"], "mallocs": f["mallocs"],
                     "alloc": f["alloc"], "cpu_ms": f["cpu_s"] * 1e3,
                     "steal_s": f["steal_s"],
                     "gc": f["gc"], "host_at_s": round(f["t0"] - origin, 4)})
    drops = []
    for r in tl.records:
        if not r.dropped:
            continue
        held = [x for x in rows if x["start"] <= r.t_arrival]
        prev = held[-1] if held else None
        win = [[w.t_start, w.t_end] for w in tl.windows
               if w.t_start <= r.t_arrival <= w.t_end + 1.0]
        drops.append({"rid": r.rid, "arrival": r.t_arrival,
                      "reason": r.drop_reason, "switch_window": win,
                      "edge_held_by": prev})
    builds = [{"key": b["key"], "host_at_s": round(b["t0"] - origin, 4),
               "wall_ms": (b["t1"] - b["t0"]) * 1e3,
               "cpu_ms": b["cpu_s"] * 1e3, "mallocs": b["mallocs"],
               "report": b.get("report")}
              for b in rec.builds]
    warm = [{"thread": f["thread"], "host_at_s": round(f["t0"] - origin, 4),
             "host_wall_ms": (f["t1"] - f["t0"]) * 1e3}
            for f in rec.forwards if f["request"] is None]
    return {"forwards": rows, "drops": drops, "builds": builds,
            "worker_forwards": warm}


HELD_KEYS = ("rid", "arrival", "split", "host_wall_ms", "t_edge_ms",
             "builds", "mallocs", "gc", "pending_builds")


def brief(line: dict) -> dict:
    """One repeat's printed summary: its stream readings, its builds, the
    (split, link) pairs its forwards were priced at, and each drop with
    the forward that held the edge."""
    out = {k: line[k] for k in (
        "repeat", "variant", "pricing", "fast", "windows", "switch_drops",
        "dropped", "p50_ms", "p99_ms", "t_edge_ms_median", "t_edge_ms_max",
        "builds")}
    out["served_at_mbps"] = sorted({(f["split"], f["mbps"])
                                    for f in line["forwards"]})
    out["drops"] = [{
        "arrival": d["arrival"], "reason": d["reason"],
        "switch_window": d["switch_window"],
        "held_by": None if d["edge_held_by"] is None else
        {k: d["edge_held_by"][k] for k in HELD_KEYS}} for d in line["drops"]]
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="vgg19")
    ap.add_argument("--strategy", default="switch_a")
    ap.add_argument("--repeats", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile-once", action="store_true")
    ap.add_argument("--out", default=os.path.join(
        ROOT, "experiments", "probe_cnn_switch.jsonl"),
        help="every repeat's full readings, one JSON line each (appended)")
    ap.add_argument("--variants", default="phase",
                    help="comma-separated, taken in turn each repeat: phase "
                         "(the stream as phase 8c drives it), unreserved "
                         "(without its reserve_cache)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        CS.fail("no CUDA device")
    from repro_torch.checkpoint import save_pytree
    from repro_torch.configs import get_config
    from repro_torch.core.hardware import EDGE_SPEC, H100
    from repro_torch.core.network import BandwidthTrace
    from repro_torch.core.pipeline import EdgeCloudPipeline
    from repro_torch.core.profiler import profile_cnn
    from repro_torch.core.stages import CnnStageRunner

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(CS.smi_line())
    gclog = CS.GcLog()
    cfg = get_config(args.arch)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    runner = CnnStageRunner(cfg, generator=gen, device="cuda")
    params, n, hw = runner.params, runner.num_units, cfg.input_hw
    frames = [torch.randn((1, hw, hw, cfg.input_ch), generator=gen,
                          device="cuda") for _ in range(CS.CNN_FRAMES)]
    index = {id(f): i for i, f in enumerate(frames)}
    pricings = {"default": {}, "h100": {"edge": EDGE_SPEC, "cloud": H100}}

    def plan():
        profiles = {name: profile_cnn(cfg, params, runner.units,
                                      runner.shapes, reps=CS.CNN_REPS, **kw)
                    for name, kw in pricings.items()}
        optima = {name: CS.split_decisions(p) for name, p in profiles.items()}
        pricing = next((name for name, dec in optima.items()
                        if len({d["split"] for d in dec.values()}) > 1), None)
        fast = optima[pricing or "default"][CS.CNN_TRACE[0][1]]["split"]
        scripted = None if pricing else (
            fast, fast + 1 if fast < n - 2 else fast - 1)
        return {"profile": profiles[pricing or "default"], "fast": fast,
                "scripted": scripted, "pricing": pricing,
                "optima": {name: {bw: d["split"] for bw, d in dec.items()}
                           for name, dec in optima.items()}}

    variants = args.variants.split(",")
    fd, ckpt = tempfile.mkstemp(suffix=".npz")
    os.close(fd)
    summary = []
    try:
        save_pytree(params, ckpt)
        p = plan()
        for rep in range(args.repeats):
            if rep and not args.profile_once:
                p = plan()
            twin = EdgeCloudPipeline(
                CnnStageRunner(cfg, params, device="cuda"), p["fast"],
                BandwidthTrace(steps=CS.CNN_TRACE).at(0.0))
            twin.build({"image": frames[0]}, cold=False)
            want = [twin.process({"image": f})[0] for f in frames]
            twin.close()
            variant = variants[rep % len(variants)]
            rec = Recorder(gclog)
            origin = time.perf_counter()
            with rec.recording():
                row, tl, seen = CS.cnn_stream(
                    cfg, params, args.strategy, frames, index, ckpt,
                    p["fast"], p["profile"], p["scripted"], want,
                    on_manager=rec.hook, reserve=variant != "unreserved")
            got = readings(rec, tl, origin)
            edge = sorted(f["t_edge_ms"] for f in got["forwards"])
            line = {"repeat": rep, "variant": variant, "arch": args.arch,
                    "strategy": args.strategy, "pricing": p["pricing"],
                    "optima": p["optima"], "fast": p["fast"],
                    "windows": row["windows"],
                    "switch_drops": row["switch_drops"],
                    "dropped": row["dropped"], "arrived": row["arrived"],
                    "p50_ms": row["p50_ms"], "p99_ms": row["p99_ms"],
                    "max_logit_diff": row["max_logit_diff"],
                    "t_edge_ms_median": edge[len(edge) // 2] if edge else None,
                    "t_edge_ms_max": edge[-1] if edge else None,
                    **got}
            summary.append(brief(line))
            print(f"[probe] repeat {rep}: {json.dumps(summary[-1])}",
                  flush=True)
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out, "a") as f:
                f.write(json.dumps(line, default=str) + "\n")
            del tl, seen, rec
            CS.free_memory()
    finally:
        os.remove(ckpt)
    print(f"[probe] garbage collections {gclog.summary()}")
    print(json.dumps({v: {
        "repeats": sum(1 for s in summary if s["variant"] == v),
        "with_switch_drops": sum(1 for s in summary
                                 if s["variant"] == v and s["switch_drops"]),
        "switch_drops": [s["switch_drops"] for s in summary
                         if s["variant"] == v],
        "t_edge_ms_max": [s["t_edge_ms_max"] for s in summary
                          if s["variant"] == v]} for v in variants}))


if __name__ == "__main__":
    main()
