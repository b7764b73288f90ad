"""Ask the reference (the JAX package, ``src/repro``) whether it serves a
slot pool of decode sessions (``serving.sessions.SessionManager``) behind
a stateful pipeline whose cloud stage moves onto a 2-way mesh, and whether
the transition reshards the slots' state.

    PYTHONPATH=src python tools/probe_reference_slot_mesh.py

Runs on the CPU only: it starts itself again in a subprocess with two
fake XLA host devices (``--xla_force_host_platform_device_count=2``) and
``JAX_PLATFORMS=cpu``.  The child seats a reduced qwen2.5-3b slot pool of
2 slots (split 1, ``max_seq`` 32), admits 2 sessions, takes 2 steps,
moves the cloud stage onto a ``(2,)`` mesh with ``switch_b2``, takes 2
more steps, and compares every step's logits with a twin pool that never
leaves one device.  Prints one JSON line: whether each stage ran or what
it raised, the transition's moved bytes, where the slots' cloud-range
state lies after the transition and after a step, and the largest logit
difference from the twin.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

FLAG = "--xla_force_host_platform_device_count=2"


def child() -> dict:
    import jax
    import numpy as np

    from repro.configs import get_config
    from repro.core.network import NetworkModel
    from repro.serving.sessions import make_session_manager

    cfg = get_config("qwen2.5-3b").reduced()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, 8) for _ in range(2)]
    out = {"devices": len(jax.devices()), "arch": cfg.name}

    def pool():
        mgr, sm = make_session_manager(cfg, split=1, net=NetworkModel(50.0),
                                       num_slots=2, max_seq=32, seed=3)
        for p in prompts:
            sm.admit(p)
        return mgr, sm

    def steps(mgr, n):
        return [np.asarray(mgr.serve(None)[0]) for _ in range(n)]

    twin, _ = pool()
    want = steps(twin, 4)
    twin.close()
    mgr, sm = pool()
    stage = "first steps"
    try:
        got = steps(mgr, 2)
        stage = "the transition onto the (2,) mesh"
        mgr.set_mesh_shape((2,))
        rep = mgr.repartition("switch_b2", 1)
        cloud = [k for k in sm.cache if not k.endswith("0")]

        def placement():
            return sorted({str(getattr(sm.cache[k], "sharding", None))
                           for k in cloud})
        out.update({"mesh_change": bool(rep.mesh_change),
                    "moved_bytes": int(mgr.pool.reshards[-1].moved_bytes),
                    "session_has_replace_state": hasattr(sm,
                                                         "replace_state"),
                    "state_after_transition": placement()})
        stage = "steps on the mesh"
        got += steps(mgr, 2)
        out["state_after_a_step"] = placement()
        out["max_logit_diff"] = float(max(np.abs(a - b).max()
                                          for a, b in zip(got, want)))
        out["serves"] = True
    except Exception as e:                # the answer, not a failure
        out.update({"serves": False, "raised_in": stage,
                    "error": f"{type(e).__name__}: {e}"})
    finally:
        mgr.close()
    return out


def main() -> None:
    if os.environ.get("PROBE_CHILD") == "1":
        print(json.dumps(child()))
        return
    env = dict(os.environ, PROBE_CHILD="1", JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"{os.environ.get('XLA_FLAGS', '')} {FLAG}".strip())
    res = subprocess.run([sys.executable, os.path.abspath(__file__)],
                         env=env, capture_output=True, text=True,
                         timeout=1800)
    sys.stderr.write(res.stderr[-4000:])
    lines = res.stdout.strip().splitlines()
    print(lines[-1] if lines else json.dumps({"rc": res.returncode}))
    sys.exit(res.returncode)


if __name__ == "__main__":
    main()
