"""Registry mapping --arch ids to the configs the port runs.

Only the architectures whose slice has been ported are listed; the others
arrive with their slices (see ROADMAP.md, Queue A).
"""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import ArchConfig, INPUT_SHAPES, InputShape

_MODULES: Dict[str, str] = {
    "qwen2.5-3b": "qwen2_5_3b",
}

ALL_ARCHS = tuple(_MODULES)


def get_config(name: str) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; the port runs: "
                       f"{sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


def get_shape(name: str) -> InputShape:
    return INPUT_SHAPES[name]
