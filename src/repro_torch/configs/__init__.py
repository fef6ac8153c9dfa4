"""Architecture registry: ``--arch <id>`` resolution.

Each module exposes CONFIG (the exact published configuration) and SMOKE
(a reduced same-family configuration for CPU smoke tests).  Copies of the
reference's ``repro.configs``: data only.  The port's model runs the
dense-attention architectures among them (``repro_torch.models.model``
raises ``NotImplementedError`` for the rest, naming what it lacks)."""

from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.models.config import ModelConfig, SHAPES, SHAPES_BY_NAME, ShapeCfg

_MODULES = {
    "mixtral-8x22b": "mixtral_8x22b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "xlstm-125m": "xlstm_125m",
    "phi3-medium-14b": "phi3_medium_14b",
    "deepseek-7b": "deepseek_7b",
    "stablelm-1.6b": "stablelm_1_6b",
    "minitron-8b": "minitron_8b",
    "qwen2-vl-7b": "qwen2_vl_7b",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.SMOKE


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}


def shape_applicable(cfg: ModelConfig, shape: ShapeCfg) -> bool:
    """long_500k runs only for sub-quadratic archs (DESIGN.md §6)."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False
    return True
