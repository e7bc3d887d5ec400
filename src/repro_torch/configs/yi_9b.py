"""Yi-9B [arXiv:2403.04652]. Llama-arch GQA kv=4."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-9b",
    family="dense",
    source="arXiv:2403.04652",
    num_layers=48,
    d_model=4096,
    vocab_size=64000,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=11008,
    rope_theta=10_000.0,
    long_context="sliding_window",
)
