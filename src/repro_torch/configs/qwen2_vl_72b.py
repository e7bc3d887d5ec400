"""Qwen2-VL-72B language backbone [arXiv:2409.12191].

M-RoPE (temporal/height/width sections), dynamic-resolution vision frontend
stubbed: input_specs() supplies precomputed patch embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    source="arXiv:2409.12191",
    num_layers=80,
    d_model=8192,
    vocab_size=152064,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    rope_theta=1_000_000.0,
    mrope_sections=(16, 24, 24),   # half-dims; sum == head_dim // 2
    multimodal=True,
    mm_embed_dim=1280,
    long_context="sliding_window",
)
