"""End-to-end serving example on the PyTorch/CUDA port: a camera streams
frames at a fixed FPS into the edge-cloud pipeline of a CNN (the paper's
own video-analytics workload, whose per-layer activation volumes VARY, so
the optimal split really moves) while the bandwidth follows the paper's
20 -> 5 -> 20 Mbps trace; a NeukonfigController repartitions live, as an
event-driven participant of the ServingEngine, while frames are in flight,
and downtime and dropped frames are MEASURED from the resulting
ServiceTimeline (the analytic simulator survives only as a cross-check).

    PYTHONPATH=src python examples/serve_pipeline_torch.py               # the card
    PYTHONPATH=src python examples/serve_pipeline_torch.py --smoke --device cpu --hw 64

The twin of ``examples/serve_pipeline.py`` on ``repro_torch``'s modules,
with the same assertions.  One more rule: where the measured profile puts
the optimum at the same split at both of the trace's bandwidths (a fast
device makes every unit's compute negligible beside the link), the
controller has nothing to do, so the switches are scripted at the trace's
change points between the optimum and its neighbour (the reference's
+-1 rule, ``examples/repartition_cnn.py``); the run says which.
Pause-and-Resume reloads a checkpoint this script writes to a temporary
directory and deletes at the end.
"""
import argparse
import dataclasses
import os
import tempfile

import numpy as np
import torch

from repro_torch.checkpoint import save_pytree
from repro_torch.configs import get_config
from repro_torch.core.controller import NeukonfigController
from repro_torch.core.downtime import crosscheck_timeline
from repro_torch.core.network import BandwidthTrace
from repro_torch.core.partitioner import optimal_split
from repro_torch.core.profiler import profile_cnn
from repro_torch.core.stages import CnnStageRunner
from repro_torch.core.strategies import available_strategies
from repro_torch.core.switching import PipelineManager
from repro_torch.serving import ServingEngine, VirtualClock, request_stream


def trace_splits(profile, trace, num_units):
    """The optimum at each of the trace's bandwidths; where it is one
    split throughout, None and the scripted pair (optimum, optimum +- 1)."""
    splits = [optimal_split(profile, trace.at(t)).split
              for t, _ in trace.steps]
    if len(set(splits)) > 1:
        return splits, None
    fast = splits[0]
    slow = fast + 1 if fast < num_units - 2 else fast - 1
    return splits, (fast, slow)


def run_strategy(strategy, cfg, params, profile, fps, duration, trace,
                 scripted, ckpt, device):
    # every strategy gets a fresh runner (cold caches) on the SAME weights
    # and the SAME measured profile: re-profiling per strategy (reps=1,
    # noisy under load) can collapse the split landscape and silence the
    # controller
    runner = CnnStageRunner(cfg, params, device=device)
    rng = np.random.default_rng(0)
    sample = {"image": torch.from_numpy(rng.standard_normal(
        (1, cfg.input_hw, cfg.input_hw, cfg.input_ch),
        dtype=np.float32)).to(runner.device)}
    split0 = scripted[0] if scripted else \
        optimal_split(profile, trace.at(0.0)).split
    mgr = PipelineManager(runner, split=split0, net=trace.at(0.0),
                          sample_inputs=sample, warm_standbys=True,
                          checkpoint_path=ckpt)
    # a deployment that has served before has its build worker running:
    # start the thread off-stream, or switch_a's first swap pays its start
    mgr.pool.executor.submit(lambda: None).wait()
    if scripted is None:
        # the controller derives candidate splits from the trace, calls
        # the strategy's prepare() hook itself, and, attached to the
        # engine, repartitions in the middle of the live frame stream
        ctl = NeukonfigController(mgr, profile, trace, strategy=strategy)
        eng = ServingEngine(mgr, clock=VirtualClock(), controller=ctl)
    else:
        ctl = None
        mgr.get_strategy(strategy).prepare(mgr.pool,
                                           candidate_splits=scripted[::-1])
        eng = ServingEngine(mgr, clock=VirtualClock())
        for i, (t, bw) in enumerate(trace.steps[1:]):
            eng.schedule_switch(t, strategy, scripted[(i + 1) % 2],
                                bandwidth_mbps=bw)
    tl = eng.run(request_stream(sample, fps=fps, duration=duration),
                 duration=duration)
    # stop this pool's build worker before the next sweep
    (ctl or mgr).close()
    total_down = tl.downtime()
    n_switch = len(tl.windows)
    moves = " ".join(f"{w.old_split}->{w.new_split}" for w in tl.windows)
    s = tl.summary()
    print(f"{strategy:13s}: {n_switch} switches ({moves}), "
          f"measured downtime {total_down*1e3:9.2f} ms, "
          f"dropped {s['dropped']}/{s['arrived']} frames, "
          f"p50 {s['p50_ms']:.1f} ms, p99 {s['p99_ms']:.1f} ms, "
          f"drained in-flight {s['drained_in_switch']}")
    return total_down, n_switch, tl


HANDOFF_HELP = """\
state handoff (stateful pipelines):
  This example's CNN stream is stateless per frame, the paper's regime,
  where a repartition only moves requests.  Decode pipelines
  (transformer KV caches, Mamba conv+SSM state) are stateful: the layers
  that change sides must also move their per-stream state, and
  repro_torch.core.stateful executes that hand-off inside every switch.
  Two arms, chosen live from the current link by plan_handoff: 'transfer'
  serializes the moved layers' state and charges the link time for the
  bytes to the stream (wins on fat links), 'recompute' re-prefills the
  moved layers on the target from boundary checkpoints and charges the
  measured wall (wins on starved links).  Every SwitchReport then carries
  t_handoff, handoff_bytes and handoff_mode; examples/serve_sessions_torch.py
  serves a slot pool of decode sessions through the same engine.
"""


def main():
    ap = argparse.ArgumentParser(
        epilog=HANDOFF_HELP,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--fps", type=float, default=4.0,
                    help="camera rate; keep below the edge stage's "
                         "sustainable rate or steady-state camera drops "
                         "dominate the switch windows")
    ap.add_argument("--arch", default="mobilenetv2")
    ap.add_argument("--hw", type=int, default=96,
                    help="input resolution (96 keeps it CPU-friendly; "
                         "the published 224 on the card)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="CI mode: same model, compressed trace (2 live "
                         "switches over 24 s instead of 90 s)")
    args = ap.parse_args()
    cfg = dataclasses.replace(get_config(args.arch), input_hw=args.hw)
    scratch = CnnStageRunner(cfg, generator=torch.Generator().manual_seed(0),
                             device=args.device)
    profile = profile_cnn(cfg, scratch.params, scratch.units, scratch.shapes,
                          reps=1)
    if args.smoke:
        fps, duration = 2.0, 24.0
        trace = BandwidthTrace(steps=[(0.0, 20.0), (8.0, 5.0), (16.0, 20.0)])
    else:
        fps, duration = args.fps, 90.0
        trace = BandwidthTrace(steps=[(0.0, 20.0), (30.0, 5.0), (60.0, 20.0)])
    splits, scripted = trace_splits(profile, trace, scratch.num_units)
    print(f"{args.arch}@{args.hw}px on {scratch.device}: optimum "
          f"{splits} at {[bw for _, bw in trace.steps]} Mbps; "
          + ("the controller repartitions" if scripted is None else
             f"it does not move, so switches are scripted "
             f"{scripted[0]} <-> {scripted[1]}"))
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, f"{args.arch}.npz")
        save_pytree(scratch.params, ckpt)
        # the live registry IS the strategy list: a new @register_strategy
        # class shows up here with no edits
        results = {s: run_strategy(s, cfg, scratch.params, profile, fps,
                                   duration, trace, scripted, ckpt,
                                   args.device)
                   for s in available_strategies()}
    downs = {s: d for s, (d, n, tl) in results.items()}
    assert all(n >= 2 for _, n, _ in results.values()), \
        "expected live switches"
    # the paper's ordering, on MEASURED stream downtime
    assert downs["switch_a"] <= downs["switch_b2"] <= downs["pause_resume"]
    assert downs["switch_pool"] <= downs["pause_resume"]
    # and the analytic simulator agrees with the measured outage windows
    _, _, tl = results["pause_resume"]
    for xc in crosscheck_timeline(tl, fps=fps, service_time=0.0):
        if xc["full_outage"]:
            assert abs(xc["measured_dropped"] - xc["predicted_dropped"]) <= 2
    print("paper ordering reproduced on the measured stream: "
          "A << B2 < baseline ✓")


if __name__ == "__main__":
    main()
