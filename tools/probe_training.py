"""Phase 11 of chip_smoke.py alone on the card: the chunked flash
attention's backward and the cross entropy's gradient against plain
autograd, then the port's ``train`` loop on qwen2.5-3b at full width and
depth (f32, AdamW, remat), the last step under torch.profiler.

    python3 tools/probe_training.py [--seed 0]

Prints chip_smoke.py's ``[train]`` lines and, last, the phase's JSON.
Builds nothing: the training path launches none of the port's kernels
(the launch counters are read to show it).  Needs one CUDA card.
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
    args = ap.parse_args()
    if not torch.cuda.is_available():
        CS.fail("no CUDA device")
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import flash_decode as FD
    from repro_torch.kernels import mamba_scan as MS
    from repro_torch.kernels import ssd_scan as SD

    torch.backends.cuda.matmul.allow_tf32 = False     # as chip_smoke.py
    torch.backends.cudnn.allow_tf32 = False
    print(CS.smi_line())
    K = CS.Counts({"flash_decode_attention": FD.flash_decode_attention,
                   "flash_attention": FA.flash_attention,
                   "mamba1_scan": MS.mamba1_scan, "ssd_scan": SD.ssd_scan})
    out = CS.phase_training(K, args.seed, CS.GcLog())
    print(json.dumps(out, default=str))


if __name__ == "__main__":
    main()
