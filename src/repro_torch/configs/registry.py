"""Registry mapping --arch ids to the configs the port runs: every
architecture of the reference's registry, each a copy of its config
module.  The paper's own CNNs (``PAPER_ARCHS``) give a ``CNNConfig``,
every other id an ``ArchConfig``.
"""
from __future__ import annotations

import importlib
from typing import Dict, Union

from repro_torch.configs.base import (ArchConfig, CNNConfig, INPUT_SHAPES,
                                      InputShape)

_MODULES: Dict[str, str] = {
    "qwen2.5-3b": "qwen2_5_3b",
    "starcoder2-7b": "starcoder2_7b",
    "yi-34b": "yi_34b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "mixtral-8x22b": "mixtral_8x22b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "zamba2-7b": "zamba2_7b",
    "internvl2-76b": "internvl2_76b",
    "whisper-medium": "whisper_medium",
    # the paper's own models (Figs. 2-3)
    "vgg19": "vgg19",
    "mobilenetv2": "mobilenetv2",
}

PAPER_ARCHS = ("vgg19", "mobilenetv2")
ASSIGNED_ARCHS = tuple(k for k in _MODULES if k not in PAPER_ARCHS)
ALL_ARCHS = tuple(_MODULES)


def get_config(name: str) -> Union[ArchConfig, CNNConfig]:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; the port runs: "
                       f"{sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


def get_shape(name: str) -> InputShape:
    return INPUT_SHAPES[name]


def pair_is_runnable(arch: str, shape: str) -> tuple[bool, str]:
    """Whether (arch, shape) is part of the 39-pair dry-run matrix (the
    reference's ``pair_is_runnable``): ``(runnable, note)``."""
    cfg = get_config(arch)
    if isinstance(cfg, CNNConfig):
        return False, "cnn: paper-figure model, not part of the assigned matrix"
    if shape == "long_500k":
        if cfg.name == "whisper-medium":
            return False, ("skipped: whisper decoder context <=448 by "
                           "construction (DESIGN.md s4)")
        if not cfg.supports_long_context():
            return False, "skipped: pure full attention (DESIGN.md s4)"
        if cfg.long_context_window is not None \
                and cfg.sliding_window is None \
                and cfg.family not in ("ssm", "hybrid"):
            return True, "[swa-variant]"
    return True, ""
