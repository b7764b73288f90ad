"""Serving launcher: runs the NEUKONFIG edge-cloud pipeline under the
request-stream ServingEngine with a scripted bandwidth trace and live
repartitioning.  Downtime, drop rate and latency percentiles are measured
from the stream's ServiceTimeline; pass ``--wall`` to pace the stream in
real time instead of the deterministic virtual clock.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \
        --strategy switch_b2 --duration 90 --fps 10 [--device cpu]

The counterpart of ``repro/launch/serve.py``, built from the port's
modules, printing the reference's fields; the reduced model runs on the
card unless ``--device`` names another device.  Weights come from
``init_model`` seeded with 0 and the request's tokens from a generator
seeded with 1.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch

from repro_torch.configs import get_config
from repro_torch.core.controller import NeukonfigController
from repro_torch.core.network import BandwidthTrace
from repro_torch.core.partitioner import optimal_split
from repro_torch.core.profiler import profile_transformer
from repro_torch.core.stages import StageRunner
from repro_torch.core.strategies import available_strategies
from repro_torch.core.switching import PipelineManager
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.serving import (ServingEngine, VirtualClock, WallClock,
                                 request_stream)


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--strategy", default="switch_b2",
                    help="any registered strategy spec, e.g. "
                         f"'switch_pool(k=2)'; names: {available_strategies()}")
    ap.add_argument("--duration", type=float, default=90.0)
    ap.add_argument("--fps", type=float, default=10.0)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--queue-depth", type=int, default=0,
                    help="admission queue slots (0 = camera keeps latest)")
    ap.add_argument("--wall", action="store_true",
                    help="pace arrivals on the real clock (demo/soak mode; "
                         "a stream heavier than the host sustains falls "
                         "behind schedule — measure with the default "
                         "virtual clock)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch).reduced()
    params = T.init_model(cfg, device=dev, seed=0)
    runner = StageRunner(cfg, params, device=dev)
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (1, args.seq), generator=gen)
    inputs = {"tokens": toks.to(dev)}

    profile = profile_transformer(cfg, seq=args.seq)
    trace = BandwidthTrace(steps=[(0.0, 20.0), (args.duration / 3, 5.0),
                                  (2 * args.duration / 3, 20.0)])
    split0 = optimal_split(profile, trace.at(0.0)).split
    mgr = PipelineManager(runner, split=split0, net=trace.at(0.0),
                          sample_inputs=inputs, warm_standbys=True)
    # the controller derives candidates from the trace and calls prepare();
    # attached to the engine, its switches happen mid-stream and are
    # measured on the stream clock
    ctl = NeukonfigController(mgr, profile, trace, strategy=args.strategy)
    eng = ServingEngine(mgr, clock=WallClock() if args.wall else VirtualClock(),
                        controller=ctl, queue_depth=args.queue_depth)
    try:
        tl = eng.run(request_stream(inputs, fps=args.fps,
                                    duration=args.duration),
                     duration=args.duration)
    finally:
        ctl.close()
        mgr.close()
    print(f"arch={cfg.name} strategy={args.strategy} "
          f"clock={'wall' if args.wall else 'virtual'}")
    for w in tl.windows:
        drops = len(tl.drops_in(w.t_start, w.t_end))
        print(f"  t={w.t_start:6.1f}s split {w.old_split}->{w.new_split} "
              f"measured window {w.duration*1e3:9.2f}ms "
              f"(analytic {w.analytic_downtime*1e3:9.2f}ms) "
              f"dropped {drops} in-window, drained {w.drained} in-flight")
    s = tl.summary()
    print(f"stream: {s['served']}/{s['arrived']} served "
          f"({s['dropped']} dropped, rate {s['drop_rate']:.3f}), "
          f"measured downtime {s['downtime_ms']:.2f} ms over "
          f"{s['n_switches']} switches")
    print(f"latency: p50 {s['p50_ms']:.1f} ms, p99 {s['p99_ms']:.1f} ms; "
          f"edge utilisation "
          f"{eng.edge.busy_total / max(tl.t_end or 1.0, 1e-9):.1%}, cloud "
          f"{eng.cloud.busy_total / max(tl.t_end or 1.0, 1e-9):.1%}")


if __name__ == "__main__":
    main()
