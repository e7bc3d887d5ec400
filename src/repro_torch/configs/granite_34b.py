"""Granite-34B-Code [arXiv:2405.04324]. Deep llama-arch with MQA (kv=1)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b",
    family="dense",
    source="arXiv:2405.04324",
    num_layers=88,
    d_model=6144,
    vocab_size=49152,
    num_heads=48,
    num_kv_heads=1,           # MQA
    head_dim=128,
    d_ff=24576,
    rope_theta=10_000.0,
    tie_embeddings=True,
    long_context="sliding_window",
)
