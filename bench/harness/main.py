"""One run of one cell: weights from the seed, the driver's set-up and
window, the check against the reference, the metrics, and the result.

``run_cell`` takes the device as an argument so that the tests can drive
a whole run on the CPU at a reduced size; ``bench/run.py`` is the entry
point, and refuses to run without the chips the cell asks for.
"""
from __future__ import annotations

import gc
import sys
import time
from typing import Optional

import torch

from bench.harness import spec as S
from bench.harness.record import Run
from bench.harness.trace import Tracer, label_idle
from bench.harness.weights import make_weights
from bench.work import model as M

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")   # top-level module names


def arch_config(port: dict):
    """The port's ``ArchConfig`` of a configuration's ``port`` group."""
    from repro_torch.configs.base import ArchConfig, SSMConfig
    fields = {k: v for k, v in port.items() if k != "ssm"}
    return ArchConfig(**fields, ssm=SSMConfig(**port["ssm"]))


def launch_counts() -> dict:
    """The program's launch counters of its four kernels."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import flash_decode as FD
    from repro_torch.kernels import mamba_scan as MS
    from repro_torch.kernels import ssd_scan as SD
    return {"flash_attention": FA.flash_attention.launches,
            "flash_decode": FD.flash_decode_attention.launches,
            "mamba1_scan": MS.mamba1_scan.launches,
            "ssd_scan": SD.ssd_scan.launches}


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one the benchmark refuses
    (compared whole: ``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Context:
    """What a driver is given: the cell, its configuration, the weights,
    the device, the run's clock and the tracer."""

    def __init__(self, cell: S.Cell, seed: int, seconds: float, trace: bool,
                 device, t_start: float, rate: Optional[float] = None):
        self.cell = cell
        self.mix = cell.mix
        self.port = cell.config["port"]
        self.cfg = arch_config(self.port)
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.device = torch.device(device)
        self.rate = rate
        self.t_start = t_start
        self.params = None
        self.notes = {}
        self.run = Run(cell.name, self.seed, self.seconds,
                       M.dims(self.port))
        self._t0 = None
        self._setup_peak = 0
        self.tracer = Tracer(trace, self.device, self.clock)

    @property
    def cuda(self) -> bool:
        return self.device.type == "cuda"

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def note(self, **kw) -> None:
        self.notes.update(kw)

    def start_window(self):
        """Ends set-up: the device idle, the peak count reset.  Returns the
        run's clock (seconds from now)."""
        self.sync()
        if self.cuda:
            self._setup_peak = torch.cuda.max_memory_allocated(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        self._t0 = time.perf_counter()
        self.run.setup_s = self._t0 - self.t_start
        return self.clock

    def clock(self) -> float:
        return time.perf_counter() - self._t0

    def sleep_until(self, t: float) -> None:
        d = t - self.clock()
        if d > 0:
            time.sleep(d)

    def end_window(self) -> None:
        self.sync()
        if self.cuda:
            peak = torch.cuda.max_memory_allocated(self.device)
            self.run.window_peak_bytes = peak
            self.run.process_peak_bytes = max(peak, self._setup_peak)


def evaluate(cell: S.Cell, readings: dict) -> tuple:
    """``(correct, limits)``: each reading held to its limit in
    ``bench/limits/<cell>.json`` (a reading with no limit fails)."""
    limits, ok = {}, True
    for name, limit in cell.limits.items():
        value = readings.get(name)
        passed = value is not None and limit is not None and value <= limit
        ok = ok and passed
        limits[name] = {"value": value, "limit": limit}
    if not cell.limits:
        ok = False
    return ok, limits


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             device="cuda", t_start: Optional[float] = None,
             control: bool = False, rate: Optional[float] = None,
             cell: Optional[S.Cell] = None, check: bool = True) -> dict:
    """One run; returns the result line's fields, ``limits`` last.
    ``check=False`` (the knee sweep's) skips the reference: the run is
    then not correct."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = cell or S.load_cell(name)
    ctx = Context(cell, seed, seconds, trace, device, t_start, rate)
    drv = S.driver(cell.mix["kind"])
    t_weights = time.perf_counter()
    ctx.params = make_weights(ctx.port, seed, ctx.device,
                              getattr(torch, cell.config["dtype"]))
    ctx.sync()
    ctx.note(setup_start_s=t_weights - t_start,
             setup_weights_s=time.perf_counter() - t_weights)
    if trace:
        ctx.tracer.calls_fn = launch_counts
    ctx.tracer.begin()
    drv.run(ctx)
    run = ctx.run
    if run.trace is None and ctx.tracer.summary is not None:
        run.trace = ctx.tracer.summary
    gc.collect()
    if ctx.cuda:
        torch.cuda.empty_cache()
    readings = drv.check(ctx, control) if check else {}
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = S.metric_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct, limits = evaluate(cell, readings)
    dev = {"platform": "gpu" if ctx.cuda else ctx.device.type,
           "kind": torch.cuda.get_device_name(ctx.device) if ctx.cuda
           else ctx.device.type,
           "count": cell.chips,
           "memory_peak_bytes": run.process_peak_bytes}
    out = {"correct": correct, "attempted": run.attempted,
           "failed": run.failed, "metrics": metrics, "device": dev}
    if run.trace is not None:
        t = run.trace
        dev["busy_s"] = t.busy_s
        dev["window_s"] = t.window_s
        ctx.note(trace_records=t.events)
        spans = [(r["kind"], r["start"], r["end"]) for r in
                 run.requests + run.steps + run.admits + run.evicts
                 + run.switches]
        out["breakdown"] = {"device_ops": t.device_ops,
                            "idle_gaps": label_idle(t, spans)}
    extra = {k: v for k, v in readings.items() if k not in limits}
    if ctx.notes or extra:
        out["notes"] = dict(ctx.notes, **extra)
    out["limits"] = limits
    return out
