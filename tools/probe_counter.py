"""Run chip_smoke.py's phase 13 alone on the card: the dry run of
qwen2.5-3b's train_4k, prefill_32k and decode_32k steps on the meta
device (13a), then the op counter around its full-width decode step and
its 1024-token stateless request on the kernel route (13b), faster than a
whole ``chip_smoke.py`` run while iterating on the counter.

    python3 tools/probe_counter.py [--seed 0] [--parts dryrun,counter]

Builds the kernels (13b launches flash_attention and flash_decode), loads
qwen2.5-3b at full width in bf16 from a seeded generator, and holds every
check of the phase as ``chip_smoke.py`` does.  Prints the phase's lines
and, last, one JSON line of its readings.  Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import chip_smoke as CS  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--parts", default="dryrun,counter")
    args = ap.parse_args()
    parts = set(args.parts.split(","))
    if not torch.cuda.is_available():
        CS.fail("no CUDA device")
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import flash_decode as FD
    from repro_torch.kernels import mamba_scan as MS
    from repro_torch.kernels import ssd_scan as SD
    from repro_torch.models.transformer import init_model

    print(CS.smi_line())
    out = {}
    if "dryrun" in parts:
        out["dryrun"] = CS.phase_dryrun()
    if "counter" in parts:
        print(f"[build] built in {build.build(force=True):.2f} s")
        K = CS.Counts({"flash_decode_attention": FD.flash_decode_attention,
                       "flash_attention": FA.flash_attention,
                       "mamba1_scan": MS.mamba1_scan,
                       "ssd_scan": SD.ssd_scan})
        cfg = get_config(CS.COUNT_ARCH)
        gen = torch.Generator(device="cuda").manual_seed(args.seed)
        params = init_model(cfg, gen, dtype=torch.bfloat16, device="cuda")
        out["counter"] = CS.phase_counter(K, cfg, params, args.seed)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
