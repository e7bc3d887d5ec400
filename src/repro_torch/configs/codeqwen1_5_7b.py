"""CodeQwen1.5-7B [hf:Qwen/CodeQwen1.5-7B]. Qwen1.5 arch, full MHA kv=32."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b",
    family="dense",
    source="hf:Qwen/CodeQwen1.5-7B",
    num_layers=32,
    d_model=4096,
    vocab_size=92416,
    num_heads=32,
    num_kv_heads=32,          # MHA
    head_dim=128,
    d_ff=13440,
    rope_theta=1_000_000.0,
    long_context="sliding_window",
)
