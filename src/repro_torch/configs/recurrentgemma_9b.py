"""RecurrentGemma-9B [arXiv:2402.19427 Griffin].

Hybrid: repeating (RG-LRU, RG-LRU, local-attention) blocks — 1:2
attention:recurrence — 38 layers total (12 full blocks + 2 RG-LRU).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    source="arXiv:2402.19427",
    num_layers=38,
    d_model=4096,
    vocab_size=256000,
    num_heads=16,
    num_kv_heads=1,           # local MQA
    head_dim=256,
    d_ff=12288,
    block_pattern=("rglru", "rglru", "attn"),
    window=2048,
    lru_width=4096,
    rope_theta=10_000.0,
    tie_embeddings=True,
    long_context="native",    # RG-LRU state + bounded local-attn window
)
