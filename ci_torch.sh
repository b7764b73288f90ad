#!/usr/bin/env bash
# CI for the PyTorch/CUDA port (src/repro_torch), on the CPU.
#
#   ./ci_torch.sh [extra pytest args]
#
# 1. the port's lint: NK01 (locks), NK02 (clocks), NK03 (host syncs on
#    the per-step path) and NK04 (registries) over src/repro_torch, with
#    no baseline file (a missing analysis-baseline-torch.json reads as
#    empty): fatal on any finding;
# 2. the port's tests, tests/test_torch_*.py, against the JAX reference
#    on the CPU (the tests marked requires_cuda skip without a card);
# 3. one pair of the dry run (qwen2.5-3b, decode_32k) on meta tensors,
#    written under experiments/dryrun_torch.
#
# On the card the port's check is `python3 chip_smoke.py`.
set -euo pipefail
cd "$(dirname "$0")"

run_py() { PYTHONPATH=src${PYTHONPATH:+:$PYTHONPATH} python "$@"; }

run_py -m repro_torch.analysis src/repro_torch
JAX_PLATFORMS=cpu run_py -m pytest -q tests/test_torch_*.py "$@"
run_py -m repro_torch.launch.dryrun --arch qwen2.5-3b --shape decode_32k
