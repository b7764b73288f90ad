"""Ask the reference (the JAX package, ``src/repro``) what its slot pool of
decode sessions (``serving.sessions.SessionManager``) does beyond steps
while its cloud stage lies on a 2-way mesh: admission, preemption and
parking, split moves on each hand-off arm, readmission, and the switch
back to one device.

    PYTHONPATH=src python tools/probe_reference_slot_mesh_ops.py

Runs on the CPU only: it starts itself again in a subprocess with two
fake XLA host devices (``--xla_force_host_platform_device_count=2``) and
``JAX_PLATFORMS=cpu``.  The child seats a reduced qwen2.5-3b slot pool of
3 slots at 4 layers (split 1, ``max_seq`` 32) and runs it through:

 1. admit 2 sessions;            2. 2 steps;
 3. switch_b2 onto ``(2,)``;     4. 2 steps;
 5. admit a third session into the free slot (5a), 2 steps, then a
    fourth into the full pool, which preempts and parks (5b), and park
    the oldest session by ``evict`` (5c);
 6. 2 steps;
 7. switch_b2 to split 3 on the mesh on the transfer arm (7a), back to
    split 1 on the recompute arm (7b) and to split 3 on the recompute arm
    (7c), 2 steps after each;
 8. readmit the parked session (preempts in turn), 2 steps;
 9. switch_b2 back to one device; 10. 2 steps.

A twin pool that never switches takes the same admissions and the same
tokens.  A stage that raises is recorded and the sequence goes on: the
twin then parks whatever the pool parked before it raised, and the
logits are compared for the sessions live in both pools only.  For each
stage it prints one
JSON line: whether the stage ran (or what it raised), the transition's
moved bytes (the reshard's for a mesh change, the hand-off's arm and
bytes for a split move), on how many devices each state entry lies, and
the largest logit difference of the sessions live in both pools from the
twin.  The last line sums the stages up.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys

FLAG = "--xla_force_host_platform_device_count=2"


def child() -> None:
    import jax
    import numpy as np

    from repro.configs import get_config
    from repro.core.network import NetworkModel
    from repro.serving.sessions import make_session_manager

    cfg = dataclasses.replace(get_config("qwen2.5-3b").reduced(),
                              num_layers=4)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (8, 5, 6, 7)]

    def pool():
        return make_session_manager(cfg, split=1, net=NetworkModel(50.0),
                                    num_slots=3, max_seq=32, seed=3)

    mgr, sm = pool()
    twin, tsm = pool()
    summary = {"devices": len(jax.devices()), "arch": cfg.name,
               "layers": cfg.num_layers, "stages": []}

    def placement():
        out = {}
        for k, v in sm.cache.items():
            sh = getattr(v, "sharding", None)
            out[k] = len(sh.device_set) if sh is not None else None
        return out

    def diff():
        live = set(sm.session_ids()) & set(tsm.session_ids())
        return float(max((np.abs(np.asarray(sm.logits_for(sid))
                                 - np.asarray(tsm.logits_for(sid))).max()
                          for sid in live), default=0.0))

    def steps(n):
        for _ in range(n):
            tok = np.asarray(tsm.next_token())
            twin.serve({"token": tok})
            mgr.serve({"token": tok})

    def admit(i):
        sid = f"s{i}"
        sm.admit(prompts[i], sid=sid)
        tsm.admit(prompts[i], sid=sid)

    def readmit(sid):
        sm.readmit(sid)
        tsm.readmit(sid)

    def switch(split, mesh, arm=None):
        mgr.pool.force_mode = arm
        n = len(mgr.pool.reshards)
        mgr.set_mesh_shape(mesh)
        rep = mgr.repartition("switch_b2", split)
        out = {"split": split, "mesh": mesh,
               "mesh_change": bool(rep.mesh_change),
               "handoff_mode": rep.handoff_mode,
               "handoff_bytes": int(rep.handoff_bytes)}
        if len(mgr.pool.reshards) > n:
            out["reshard_moved_bytes"] = int(
                mgr.pool.reshards[-1].moved_bytes)
        return out

    stages = [
        ("1 admit 2 sessions", lambda: admit(0) or admit(1)),
        ("2 steps", lambda: steps(2)),
        ("3 switch_b2 onto (2,)", lambda: switch(1, (2,))),
        ("4 steps", lambda: steps(2)),
        ("5a admit into the free slot", lambda: admit(2)),
        ("5a steps", lambda: steps(2)),
        ("5b admit into the full pool", lambda: admit(3)),
        ("5c evict (park) s0", lambda: sm.evict("s0") or tsm.evict("s0")),
        ("6 steps", lambda: steps(2)),
        ("7a switch_b2 to split 3, transfer",
         lambda: switch(3, (2,), "transfer")),
        ("7a steps", lambda: steps(2)),
        ("7b switch_b2 to split 1, recompute",
         lambda: switch(1, (2,), "recompute")),
        ("7b steps", lambda: steps(2)),
        ("7c switch_b2 to split 3, recompute",
         lambda: switch(3, (2,), "recompute")),
        ("7c steps", lambda: steps(2)),
        ("8 readmit the parked session", lambda: readmit("s0")),
        ("8 steps", lambda: steps(2)),
        ("9 switch_b2 back to one device", lambda: switch(3, None)),
        ("10 steps", lambda: steps(2)),
    ]
    try:
        for name, fn in stages:
            rec = {"stage": name}
            try:
                res = fn()
                rec["ran"] = True
                if isinstance(res, dict):
                    rec.update(res)
            except Exception as e:          # the answer, not a failure
                rec.update({"ran": False,
                            "error": f"{type(e).__name__}: {e}"})
                for sid in set(sm.parked_ids()) - set(tsm.parked_ids()):
                    tsm.evict(sid)
            rec["live"] = sm.session_ids()
            rec["parked"] = sm.parked_ids()
            rec["placement"] = placement()
            if rec["ran"]:
                rec["max_logit_diff"] = diff()
            print(json.dumps(rec), flush=True)
            summary["stages"].append({k: rec.get(k) for k in (
                "stage", "ran", "error", "max_logit_diff",
                "reshard_moved_bytes", "handoff_mode", "handoff_bytes")})
    finally:
        mgr.close()
        twin.close()
    summary["serves"] = all(s["ran"] for s in summary["stages"])
    print(json.dumps(summary))


def main() -> None:
    if os.environ.get("PROBE_CHILD") == "1":
        child()
        return
    env = dict(os.environ, PROBE_CHILD="1", JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"{os.environ.get('XLA_FLAGS', '')} {FLAG}".strip())
    res = subprocess.run([sys.executable, os.path.abspath(__file__)],
                         env=env, capture_output=True, text=True,
                         timeout=1800)
    sys.stderr.write(res.stderr[-4000:])
    sys.stdout.write(res.stdout)
    sys.exit(res.returncode)


if __name__ == "__main__":
    main()
