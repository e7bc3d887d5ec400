"""Llama-4 Scout 17B-active / 16 experts [hf:meta-llama/Llama-4-Scout-17B-16E].

MoE with top-1 routed expert + one shared expert; early-fusion multimodal
(vision frontend stubbed to precomputed embeddings per the assignment).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
    num_layers=48,
    d_model=5120,
    vocab_size=202048,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    num_experts=16,
    top_k=1,
    shared_expert=True,
    multimodal=True,
    mm_embed_dim=1408,
    rope_theta=500_000.0,
    long_context="sliding_window",
)
