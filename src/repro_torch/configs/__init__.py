"""Architecture config registry (``--arch <id>``) of the PyTorch port: the
JAX package's ten architectures, field for field.

Families: dense attention (qwen3-4b, yi-9b, codeqwen1.5-7b, granite-34b),
routed MoE (qwen3-moe-30b-a3b), pure SSM (mamba2-1.3b), the hybrid RG-LRU
family (recurrentgemma-9b) and the multimodal configs, whose conditioning
embeddings go through ``mm_proj`` (musicgen-medium; qwen2-vl-72b with
M-RoPE; llama4-scout-17b-a16e, MoE with top-1 routing and a shared
expert). Three do not fit one 80 GB card in bf16 at full width and run
``.reduced()`` only: granite-34b (93.9 GB), qwen2-vl-72b (145 GB) and
llama4-scout-17b-a16e (216 GB).
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import INPUT_SHAPES, InputShape, ModelConfig

_MODULES = {
    "qwen2-vl-72b": "qwen2_vl_72b",                    # reduced only: 145 GB
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",  # reduced only: 216 GB
    "qwen3-4b": "qwen3_4b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "mamba2-1.3b": "mamba2_1_3b",
    "yi-9b": "yi_9b",
    "musicgen-medium": "musicgen_medium",
    "granite-34b": "granite_34b",                      # reduced only: 93.9 GB
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
