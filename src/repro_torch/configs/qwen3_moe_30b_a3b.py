"""Qwen3-MoE 30B-A3B [hf:Qwen/Qwen3-30B-A3B]. 128 experts, top-8, qk_norm."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    source="hf:Qwen/Qwen3-30B-A3B",
    num_layers=48,
    d_model=2048,
    vocab_size=151936,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=768,                 # per-expert FFN dim
    num_experts=128,
    top_k=8,
    qk_norm=True,
    rope_theta=1_000_000.0,
    long_context="sliding_window",
)
