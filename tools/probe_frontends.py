"""Run chip_smoke.py's frontend-model phases alone on the card: the two
attention kernels against their plain versions (phase 3's flash_decode
and flash_attention parts, every shape, whisper-medium's and
internvl2-76b's among them), internvl2-76b (6 of 80 layers) through
phases 4-6 and its standalone prefill and decode steps, and
whisper-medium at full depth (phase 10), faster than a whole
``chip_smoke.py`` run while iterating on these paths.

    python3 tools/probe_frontends.py [--parts kernels,internvl2,whisper]
                                     [--seed 0]

Builds the kernels first; every check of these phases holds as in
``chip_smoke.py``, TF32 off as there.  Prints the phases' lines and, last,
one JSON line of their readings.  Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import chip_smoke as CS  # noqa: E402

PARTS = ("kernels", "internvl2", "whisper")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parts", default=",".join(PARTS))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    parts = args.parts.split(",")
    if not torch.cuda.is_available():
        CS.fail("no CUDA device")
    if set(parts) - set(PARTS):
        CS.fail(f"unknown parts {set(parts) - set(PARTS)}; known {PARTS}")
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import flash_decode as FD
    from repro_torch.kernels import mamba_scan as MS
    from repro_torch.kernels import ssd_scan as SD

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    print(CS.smi_line())
    print(f"[build] {build.build(force=True):.2f} s")
    K = CS.Counts({"flash_decode_attention": FD.flash_decode_attention,
                   "flash_attention": FA.flash_attention,
                   "mamba1_scan": MS.mamba1_scan, "ssd_scan": SD.ssd_scan})
    gclog = CS.GcLog()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    out = {}
    if "kernels" in parts:
        out["flash_decode_attention"] = CS.phase_kernel(FD, gen)
        out["flash_attention"] = CS.phase_prefill_kernel(FA, gen)
    if "internvl2" in parts:
        out["internvl2"] = CS.run_model(K, "internvl2-76b", args.seed, gclog)
    if "whisper" in parts:
        out["whisper"] = CS.phase_whisper(K, args.seed, gclog)
    CS.check("jax" not in sys.modules, "the port imported jax")
    print(f"[probe] {time.perf_counter() - t0:.1f} s; garbage collections "
          f"{gclog.summary()}")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
