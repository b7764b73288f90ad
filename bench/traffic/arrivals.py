"""Arrival processes: ``poisson`` from the port's ``serving/workload.py``
(frozen here so that the benchmark's traffic cannot move with the
program), given by its gap distribution, from which
``bench/traffic/generator.py`` takes a fixed set of gaps.
"""
from __future__ import annotations

import math

import numpy as np


class Poisson:
    """Memoryless arrivals: exponential gaps at ``rate``."""

    def __init__(self, rate: float):
        if rate <= 0:
            raise ValueError(f"rate must be positive ({rate=})")
        self.rate = float(rate)

    def mean_rate(self) -> float:
        return self.rate

    def gap_quantile(self, q: float) -> float:
        return -math.log1p(-q) / self.rate


PROCESSES = {"poisson": Poisson}


def make(spec: dict):
    """``{"process": name, **params}`` -> the process."""
    params = {k: v for k, v in spec.items() if k != "process"}
    return PROCESSES[spec["process"]](**params)


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """A generator for one independent stream of a run's draws."""
    return np.random.default_rng([int(seed), int(stream)])
