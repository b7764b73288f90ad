"""Three-term roofline of one step, priced on the port's card.

The counterpart of ``repro/distributed/roofline.py``:

  compute    = flops            / (chips * peak FLOP/s)
  memory     = bytes            / (chips * HBM bandwidth)
  collective = collective bytes / (chips * link bandwidth)

The quantities are global (the whole step over every chip).  They come
from ``distributed.op_analysis`` (the operators one eager step
dispatches, in place of the reference's HLO analysis); ``step_cost``
counts one call, in place of ``executable_cost``.  Every record is
priced with ``core.hardware``'s ``H100`` (its dense bf16 peak and HBM3
bandwidth) and ``NVLINK_BW``, and names the spec it was priced with.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Any, Callable, Dict, Optional

from repro_torch.core.hardware import H100, NVLINK_BW
from repro_torch.distributed.op_analysis import count


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    # global quantities
    hlo_flops: float
    hlo_bytes: float
    coll_bytes: float
    coll_breakdown: Dict[str, Any]
    model_flops: float
    # terms (seconds)
    t_compute: float = 0.0
    t_memory: float = 0.0
    t_collective: float = 0.0
    bottleneck: str = ""
    useful_flops_frac: float = 0.0
    per_device_bytes: Optional[int] = None
    device_spec: str = H100.name
    link_bw: float = NVLINK_BW

    def finish(self):
        chips = self.chips
        self.t_compute = self.hlo_flops / (chips * H100.flops)
        self.t_memory = self.hlo_bytes / (chips * H100.hbm_bw)
        self.t_collective = self.coll_bytes / (chips * NVLINK_BW)
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        self.bottleneck = max(terms, key=terms.get)
        self.useful_flops_frac = (self.model_flops / self.hlo_flops
                                  if self.hlo_flops else 0.0)
        return self

    def to_dict(self):
        return asdict(self)


@dataclass
class KernelRoofline:
    """Achieved against peak rates for ONE measured call.

    ``hlo_flops``/``hlo_bytes`` are the call's counted work
    (``step_cost``); ``wall_s`` its measured time.  The fractions compare
    the achieved rates with the H100's peaks; ``bound`` says which of the
    two the counted work alone would make the floor."""
    name: str
    wall_s: float
    hlo_flops: float
    hlo_bytes: float
    achieved_flops_per_s: float = 0.0
    achieved_bytes_per_s: float = 0.0
    flops_frac: float = 0.0
    bw_frac: float = 0.0
    bound: str = ""
    device_spec: str = H100.name

    def finish(self):
        if self.wall_s > 0:
            self.achieved_flops_per_s = self.hlo_flops / self.wall_s
            self.achieved_bytes_per_s = self.hlo_bytes / self.wall_s
        self.flops_frac = self.achieved_flops_per_s / H100.flops
        self.bw_frac = self.achieved_bytes_per_s / H100.hbm_bw
        t_compute = self.hlo_flops / H100.flops
        t_memory = self.hlo_bytes / H100.hbm_bw
        self.bound = "memory" if t_memory >= t_compute else "compute"
        return self

    def to_dict(self):
        return asdict(self)


def step_cost(fn: Callable, *args, **kwargs) -> Dict[str, float]:
    """``flops`` / ``bytes accessed`` of one call of ``fn`` (the counter
    around it), with the counter's other totals beside them."""
    _, c = count(fn, *args, **kwargs)
    t = c.totals()
    return dict(t, **{"bytes accessed": t["bytes"]})


def kernel_roofline(name: str, *, wall_s: float,
                    cost: Optional[Dict[str, float]] = None
                    ) -> KernelRoofline:
    """A ``KernelRoofline`` from a measured wall and ``step_cost``'s
    count."""
    cost = cost or {"flops": 0.0, "bytes accessed": 0.0}
    return KernelRoofline(name, wall_s, cost.get("flops", 0.0),
                          cost.get("bytes accessed", 0.0)).finish()


def model_flops_estimate(cfg, shape) -> float:
    """6*N*D (dense) / 6*N_active*D (MoE); decode: D = new tokens only."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    tokens = shape.global_batch * 1
    return 2.0 * n * tokens
