"""Run chip_smoke.py's phase 8 alone on the card: the paper's CNNs (VGG19,
MobileNetV2) at 224 px through the measured profile, the controller and
the serving engine, faster than a whole ``chip_smoke.py`` run while
iterating on the CNN path.

    python3 tools/probe_cnn.py [--seed 0]

Builds no kernel (none lies on this path); every check of the phase holds
as in ``chip_smoke.py``, TF32 off as there.  Prints the phase's lines and,
last, one JSON line of its readings.  Needs one CUDA card.
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

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(CS.smi_line())
    K = CS.Counts({"flash_decode_attention": FD.flash_decode_attention,
                   "flash_attention": FA.flash_attention,
                   "mamba1_scan": MS.mamba1_scan, "ssd_scan": SD.ssd_scan})
    gclog = CS.GcLog()
    out = [CS.phase_cnn(K, arch, args.seed, gclog) for arch in CS.CNN_ARCHS]
    print(f"[probe] garbage collections {gclog.summary()}")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
