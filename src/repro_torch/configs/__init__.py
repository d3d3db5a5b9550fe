"""Architecture registry: ``--arch <id>`` ids map to one config module each.

The port carries the configs its slices run; ``input_specs`` (the dry-run's
shape stand-ins) comes with the model slice.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

_MODULES = {
    "qwen2-1.5b": "repro_torch.configs.qwen2_1p5b",
    "granite-moe-3b-a800m": "repro_torch.configs.granite_moe_3b",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    mod = importlib.import_module(_MODULES[arch])
    return mod.smoke_config() if smoke else mod.get_config()
