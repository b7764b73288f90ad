"""Phase 12 of chip_smoke.py alone on the card: qwen2.5-3b at full width
and depth (bf16, the script's seeded weights) with its cloud stage on a
2-way tensor-parallel mesh, one shard a card where there are two cards,
else both on ``cuda:0``: the attention kernels at a shard's shapes, the
stateless and the stateful pipelines moved onto the mesh and back, and
the readings phase 12 prints.

    python3 tools/probe_sharding.py [--seed 0]

Builds the kernels first; every check of the phase holds as in
``chip_smoke.py``, TF32 off as there.  Prints the phase's lines and, last,
one JSON line of its readings.  Needs one CUDA card.
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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        CS.fail("no CUDA device")
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import flash_decode as FD
    from repro_torch.kernels import mamba_scan as MS
    from repro_torch.kernels import ssd_scan as SD
    from repro_torch.models.transformer import init_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    print(CS.smi_line())
    print(f"[build] {build.build(force=True):.2f} s")
    K = CS.Counts({"flash_decode_attention": FD.flash_decode_attention,
                   "flash_attention": FA.flash_attention,
                   "mamba1_scan": MS.mamba1_scan, "ssd_scan": SD.ssd_scan})
    cfg = get_config(CS.SERVE_ARCH)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    params = init_model(cfg, gen, dtype=torch.bfloat16, device="cuda")
    gclog = CS.GcLog()
    out = CS.phase_sharding(K, cfg, params, args.seed, gclog)
    CS.check("jax" not in sys.modules, "the port imported jax")
    print(f"[probe] {time.perf_counter() - t0:.1f} s; garbage collections "
          f"{gclog.summary()}")
    print(json.dumps(out, default=str))


if __name__ == "__main__":
    main()
