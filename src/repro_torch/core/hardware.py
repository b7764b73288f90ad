"""Hardware constants.

Two profiles share the same partitioning math:

* ``paper``  — the paper's lab testbed (edge: 4-core x86, cloud: 8-core x86,
  link 5-20 Mbps).  Used by the downtime reproduction, where compute times
  are MEASURED on this host and scaled by the edge/cloud speed ratio.
  Carried over unchanged from the reference package.
* ``h100`` — the port's card: an NVIDIA H100 SXM.  The numbers are NVIDIA's
  data-sheet peaks (dense bf16 without sparsity, HBM3 bandwidth, device
  memory at the full 700 W power limit), not measurements; kernel bounds
  and roofline shares are stated against them.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class DeviceSpec:
    name: str
    flops: float            # peak FLOP/s (dense bf16 for the H100)
    hbm_bw: float           # bytes/s
    mem_bytes: int
    mfu: float = 0.4        # assumed utilisation for analytic latency


# data-sheet constants of the H100 SXM (not measured)
H100 = DeviceSpec("h100_sxm", flops=989e12, hbm_bw=3.35e12,
                  mem_bytes=80 * 2 ** 30)
# its float32 rate outside the tensor cores (the scans' elementwise work)
H100_F32_FLOPS = 67e12
# its exponentials: the special-function unit (MUFU.EX2) completes 16 a
# clock on each SM of compute capability 9.0 (CUDA C++ Programming Guide,
# the arithmetic-instruction throughput table), on 132 SMs at the 1,980
# MHz that ``nvidia-smi --query-gpu=clocks.max.sm`` reports for the card
H100_SMS = 132
H100_MAX_SM_CLOCK_HZ = 1.98e9
H100_EXP_RATE = 16 * H100_SMS * H100_MAX_SM_CLOCK_HZ     # exps/s
# its NVLink 4: 18 links of 25 GB/s each way, 450 GB/s per direction (the
# data sheet's 900 GB/s counts both); the per-mesh latency model prices
# the tensor-parallel all-reduces with it.  The reference's ICI_LINK_BW is
# a TPU figure and does not carry over.
NVLINK_BW = 450e9           # bytes/s per direction

# paper testbed analogue: edge is ~4x weaker than cloud (4 vs 8 cores,
# and the paper's edge VM has half the RAM); exact ratio only shifts the
# curves, not the phenomenon.
EDGE_SPEC = DeviceSpec("edge-4core", flops=0.2e12, hbm_bw=20e9,
                       mem_bytes=8 * 2 ** 30, mfu=0.3)
CLOUD_SPEC = DeviceSpec("cloud-8core", flops=0.8e12, hbm_bw=40e9,
                        mem_bytes=16 * 2 ** 30, mfu=0.3)
