"""MusicGen-medium decoder [arXiv:2306.05284].

Decoder-only transformer over EnCodec tokens; the EnCodec conv codec +
conditioning (T5) frontend is stubbed: input_specs() provides conditioning
embeddings, the model consumes audio-token ids directly.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    source="arXiv:2306.05284",
    num_layers=48,
    d_model=1536,
    vocab_size=2048,
    num_heads=24,
    num_kv_heads=24,          # MHA
    head_dim=64,
    d_ff=6144,
    multimodal=True,          # conditioning embeddings (stub frontend)
    mm_embed_dim=768,
    rope_theta=10_000.0,
    long_context="sliding_window",
)
