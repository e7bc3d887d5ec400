"""Qwen3-4B [hf:Qwen/Qwen3-8B family]. qk_norm + GQA."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b",
    family="dense",
    source="hf:Qwen/Qwen3-8B",
    num_layers=36,
    d_model=2560,
    vocab_size=151936,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=9728,
    qk_norm=True,
    rope_theta=1_000_000.0,
    long_context="sliding_window",
)
