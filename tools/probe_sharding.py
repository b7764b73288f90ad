"""Phase 12 of chip_smoke.py alone on the card: a model at full width
(bf16, the script's seeded weights; at phase 12's depth, or ``--layers``)
with its cloud stage on a 2-way tensor-parallel mesh, one shard a card
where there are two cards, else both on ``cuda:0``: the kernels at a
shard's shapes, the stateless and (but for whisper-medium) the stateful
pipelines moved onto the mesh and back, and the readings phase 12 prints.

    python3 tools/probe_sharding.py [--arch qwen2.5-3b,zamba2-7b,...]
        [--layers N] [--seed 0]

Builds the kernels first; every check of the phase holds as in
``chip_smoke.py``, TF32 off as there.  Prints the phase's lines and, last,
one JSON line of its readings.  Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import dataclasses
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
    ap.add_argument("--arch", default=CS.SERVE_ARCH,
                    help="comma-separated: any of chip_smoke.SHARD_ARCHS "
                         "and whisper-medium")
    ap.add_argument("--layers", type=int, default=None,
                    help="decoder layers (default: the phase's depth)")
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
    gclog = CS.GcLog()
    out = []
    for arch in args.arch.split(","):
        cfg = get_config(arch)
        depth = args.layers or CS.DEPTH.get(arch)
        if depth:
            cfg = dataclasses.replace(cfg, num_layers=depth)
        gen = torch.Generator(device="cuda").manual_seed(args.seed)
        params = init_model(cfg, gen, dtype=torch.bfloat16, device="cuda")
        out.append(CS.phase_sharding(K, cfg, params, args.seed, gclog,
                                     stateful=cfg.family != "audio"))
        del params
        CS.free_memory()
    CS.check("jax" not in sys.modules, "the port imported jax")
    print(f"[probe] {time.perf_counter() - t0:.1f} s; garbage collections "
          f"{gclog.summary()}")
    print(json.dumps(out, default=str))


if __name__ == "__main__":
    main()
