"""Architecture registry: the 10 assigned architectures (+ paper models).

Copy of ``repro.configs``; the port imports nothing of ``repro``.
"""

from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import ModelConfig, reduced  # noqa: F401
from repro_torch.configs.shapes import SHAPES, InputShape, get_shape  # noqa: F401

_ARCH_MODULES = {
    "granite-moe-1b-a400m": "repro_torch.configs.granite_moe_1b_a400m",
    "recurrentgemma-9b": "repro_torch.configs.recurrentgemma_9b",
    "qwen2-7b": "repro_torch.configs.qwen2_7b",
    "seamless-m4t-medium": "repro_torch.configs.seamless_m4t_medium",
    "gemma2-2b": "repro_torch.configs.gemma2_2b",
    "command-r-35b": "repro_torch.configs.command_r_35b",
    "minitron-8b": "repro_torch.configs.minitron_8b",
    "xlstm-350m": "repro_torch.configs.xlstm_350m",
    "internvl2-1b": "repro_torch.configs.internvl2_1b",
    "dbrx-132b": "repro_torch.configs.dbrx_132b",
}

ARCH_NAMES = tuple(_ARCH_MODULES)


def get_config(name: str) -> ModelConfig:
    """Look up an assigned architecture config by id (``--arch <id>``)."""
    try:
        module = importlib.import_module(_ARCH_MODULES[name])
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_ARCH_MODULES)}") from None
    return module.CONFIG


def all_configs() -> Dict[str, ModelConfig]:
    return {name: get_config(name) for name in ARCH_NAMES}
