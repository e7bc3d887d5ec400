"""Architecture config registry (``--arch <id>``) of the PyTorch port.

Only the architectures whose whole serving path is ported are registered:
the dense attention family (qwen3-4b, yi-9b, codeqwen1.5-7b, granite-34b),
the routed MoE family (qwen3-moe-30b-a3b), pure SSM (mamba2-1.3b) and the
hybrid RG-LRU family (recurrentgemma-9b). The multimodal architectures of
the JAX package's registry (qwen2-vl-72b, llama4-scout-17b-a16e,
musicgen-medium) are not ported yet.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import INPUT_SHAPES, InputShape, ModelConfig

_MODULES = {
    "qwen3-4b": "qwen3_4b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "mamba2-1.3b": "mamba2_1_3b",
    "yi-9b": "yi_9b",
    "granite-34b": "granite_34b",
    "codeqwen1.5-7b": "codeqwen1_5_7b",
    "recurrentgemma-9b": "recurrentgemma_9b",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; choose from {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG


def get_shape(name: str) -> InputShape:
    return INPUT_SHAPES[name]


__all__ = [
    "ARCH_IDS",
    "INPUT_SHAPES",
    "InputShape",
    "ModelConfig",
    "get_config",
    "get_shape",
]
