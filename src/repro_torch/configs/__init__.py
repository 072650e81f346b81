"""Architecture registry (port of ``configs/__init__.py``, without the JAX
shape-spec helpers).  ``get_config(name)`` returns the assigned ModelConfig;
the configuration files are plain data, copied from the JAX package."""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.models.config import (
    ModelConfig, ShapeCell, SHAPE_CELLS, SHAPES_BY_NAME, cell_is_applicable,
)

ARCH_MODULES: Dict[str, str] = {
    "h2o-danube-3-4b": "h2o_danube3_4b",
    "gemma-7b": "gemma_7b",
    "qwen1.5-0.5b": "qwen1_5_0_5b",
    "yi-34b": "yi_34b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "mixtral-8x7b": "mixtral_8x7b",
    "whisper-tiny": "whisper_tiny",
    "mamba2-370m": "mamba2_370m",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "zamba2-2.7b": "zamba2_2_7b",
}

ARCH_NAMES = tuple(ARCH_MODULES)


def get_config(name: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{ARCH_MODULES[name]}")
    return mod.CONFIG


__all__ = ["ARCH_MODULES", "ARCH_NAMES", "get_config", "ModelConfig",
           "ShapeCell", "SHAPE_CELLS", "SHAPES_BY_NAME", "cell_is_applicable"]
