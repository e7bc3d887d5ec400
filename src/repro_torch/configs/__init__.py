"""Architecture config registry (``--arch <id>``) of the PyTorch port.

Only the architectures whose whole serving path is ported are registered:
one of each family the port serves (dense attention, pure SSM, the hybrid
RG-LRU family). The MoE and multimodal architectures of the JAX package's
registry are not ported yet.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import INPUT_SHAPES, InputShape, ModelConfig

_MODULES = {
    "qwen3-4b": "qwen3_4b",
    "mamba2-1.3b": "mamba2_1_3b",
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
