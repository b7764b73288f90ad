"""Multi-session continuous-batching demo on the PyTorch/CUDA port: N
concurrent decode sessions share one slot-indexed pool
(``make_session_manager``) behind the ``ServingEngine``; some sessions are
admitted up front, the rest arrive mid-stream (``schedule_admit``), and
one repartition fires while every session is decoding.  The whole pool's
state moves as ONE batched hand-off, no session is dropped, and the
``ServiceTimeline`` attributes each served step to the sessions that were
live for it — per-session p99 comes straight from
``timeline.session_summary()``.

    PYTHONPATH=src python examples/serve_sessions_torch.py [--smoke]
    PYTHONPATH=src python examples/serve_sessions_torch.py --device cpu

The steps of ``examples/serve_sessions.py``, on ``repro_torch``'s
modules; the device defaults to the card.
"""
import argparse
import dataclasses

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core.network import NetworkModel
from repro_torch.serving import (ServingEngine, VirtualClock,
                                 make_session_manager, request_stream)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="tiny run for CI: fewer sessions, shorter stream")
    ap.add_argument("--sessions", type=int, default=None,
                    help="total concurrent sessions (default 8, smoke 4)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    args = ap.parse_args()
    n = args.sessions or (4 if args.smoke else 8)
    duration = 4.0 if args.smoke else 8.0

    cfg = dataclasses.replace(get_config("qwen2.5-3b").reduced(),
                              num_layers=2)
    mgr, sm = make_session_manager(cfg, split=cfg.num_layers,
                                   net=NetworkModel(20.0), num_slots=n,
                                   max_seq=64, seed=0, device=args.device)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size,
                            size=int(rng.integers(4, 17))).astype(np.int32)
               for _ in range(n)]
    # half the sessions are live from t=0; the rest arrive mid-stream
    # while decode steps are in flight
    for i in range(n // 2):
        sm.admit(prompts[i], sid=f"s{i}")
    eng = ServingEngine(mgr, clock=VirtualClock())
    for i in range(n // 2, n):
        eng.schedule_admit(0.5 + 0.25 * (i - n // 2), prompts[i],
                           sid=f"s{i}")
    # one mid-stream repartition: the pool hands off every live slot's
    # state in a single batched payload, then decoding resumes
    eng.schedule_switch(duration / 2, "switch_b2", 1)

    tl = eng.run(request_stream({}, fps=4.0, duration=duration),
                 duration=duration)

    live = sm.session_ids()
    assert len(live) == n, f"dropped sessions: expected {n}, got {len(live)}"
    s = tl.summary()
    print(f"{n} sessions, {len(tl.windows)} mid-stream switch(es), "
          f"downtime {tl.downtime()*1e3:.1f} ms, "
          f"dropped {s['dropped']}/{s['arrived']} steps")
    print(f"{'session':>8s} {'steps':>6s} {'p50_ms':>9s} {'p99_ms':>9s} "
          f"{'pos':>5s}")
    for sid in sorted(tl.session_summary()):
        row = tl.session_summary()[sid]
        pos = sm.slot_info(sid).pos
        p50 = "-" if row["p50_ms"] is None else f"{row['p50_ms']:.1f}"
        p99 = "-" if row["p99_ms"] is None else f"{row['p99_ms']:.1f}"
        print(f"{sid:>8s} {row['served']:>6d} {p50:>9s} {p99:>9s} {pos:>5d}")
    mgr.close()
    print("serve_sessions_torch: OK")


if __name__ == "__main__":
    main()
