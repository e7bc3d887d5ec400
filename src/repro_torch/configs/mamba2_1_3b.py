"""Mamba-2 1.3B [arXiv:2405.21060]. Attention-free SSD (state-space duality)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    source="arXiv:2405.21060",
    num_layers=48,
    d_model=2048,
    vocab_size=50280,
    d_ff=0,                    # attention-free, no MLP block (SSD block only)
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_conv=4,
    ssm_chunk=64,
    tie_embeddings=True,
    long_context="native",     # O(1) state per token
)
