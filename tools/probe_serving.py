"""Run chip_smoke.py's phase 7 alone on the card: qwen2.5-3b at full width
behind the ``ServingEngine``, faster than a whole ``chip_smoke.py`` run
while iterating on the serving layer.

    python3 tools/probe_serving.py [--seed 0]

Builds the kernels, makes the model as ``chip_smoke.py``'s ``run_model``
does (bf16, random weights from a generator seeded with ``--seed``),
writes the checkpoint pause_resume reloads to ``$TMPDIR`` (deleted at the
end), then runs ``phase_serving`` once; every check of the phase holds as
in ``chip_smoke.py``.  Prints the phase's lines and, last, one JSON line
of its readings.  Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import chip_smoke as CS  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        CS.fail("no CUDA device")
    from repro_torch.checkpoint import save_pytree
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import flash_decode as FD
    from repro_torch.kernels import mamba_scan as MS
    from repro_torch.kernels import ssd_scan as SD
    from repro_torch.models.transformer import init_model

    print(CS.smi_line())
    t_build = build.build()
    print(f"[build] {t_build:.1f} s")
    K = CS.Counts({"flash_decode_attention": FD.flash_decode_attention,
                   "flash_attention": FA.flash_attention,
                   "mamba1_scan": MS.mamba1_scan, "ssd_scan": SD.ssd_scan})
    gclog = CS.GcLog()
    cfg = get_config(CS.SERVE_ARCH)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    params = init_model(cfg, gen, dtype=torch.bfloat16, device="cuda")
    fd, ckpt = tempfile.mkstemp(suffix=".npz")
    os.close(fd)
    try:
        sw = time.perf_counter()
        save_pytree(params, ckpt)
        print(f"[probe] checkpoint written in {time.perf_counter() - sw:.1f}"
              f" s")
        sw = time.perf_counter()
        out = CS.phase_serving(K, cfg, params, ckpt, args.seed, gclog)
        out["phase_wall_s"] = time.perf_counter() - sw
        print(f"[probe] phase 7 took {out['phase_wall_s']:.1f} s")
    finally:
        os.remove(ckpt)
    print(f"[probe] garbage collections {gclog.summary()}")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
