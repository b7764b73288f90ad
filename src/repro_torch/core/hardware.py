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

# paper testbed analogue: edge is ~4x weaker than cloud (4 vs 8 cores,
# and the paper's edge VM has half the RAM); exact ratio only shifts the
# curves, not the phenomenon.
EDGE_SPEC = DeviceSpec("edge-4core", flops=0.2e12, hbm_bw=20e9,
                       mem_bytes=8 * 2 ** 30, mfu=0.3)
CLOUD_SPEC = DeviceSpec("cloud-8core", flops=0.8e12, hbm_bw=40e9,
                        mem_bytes=16 * 2 ** 30, mfu=0.3)
