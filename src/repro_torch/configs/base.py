"""Configuration dataclasses for the repro framework.

ModelConfig describes one architecture from the assigned pool; InputShape
describes one of the four assigned workload shapes. Full configs are only
ever lowered (ShapeDtypeStruct dry-run); reduced() variants run on CPU.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    source: str                      # citation for the config
    num_layers: int
    d_model: int
    vocab_size: int
    # attention
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    qk_norm: bool = False
    rope_theta: float = 1_000_000.0
    mrope_sections: Tuple[int, ...] = ()   # M-RoPE half-dim sections (qwen2-vl)
    # mlp
    d_ff: int = 0
    # moe
    num_experts: int = 0
    top_k: int = 0
    shared_expert: bool = False
    capacity_factor: float = 1.25
    # ssm (mamba2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 64
    # hybrid (recurrentgemma): repeating block pattern of layer kinds
    block_pattern: Tuple[str, ...] = ()    # e.g. ("rglru", "rglru", "attn")
    window: int = 0                        # local-attention window
    lru_width: int = 0
    # modality frontend stub (vlm / audio): precomputed embeddings input
    multimodal: bool = False
    mm_embed_dim: int = 0
    # long-context policy for long_500k decode
    long_context: str = "skip"             # "native" | "sliding_window" | "skip"
    sliding_window: int = 8192
    # misc
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"

    # ------------------------------------------------------------------
    @property
    def attn_layers(self) -> Tuple[str, ...]:
        """Per-layer kind sequence for the full depth."""
        if self.family == "ssm":
            return ("ssm",) * self.num_layers
        if self.block_pattern:
            seq = []
            while len(seq) < self.num_layers:
                seq.extend(self.block_pattern)
            return tuple(seq[: self.num_layers])
        if self.num_experts > 0:
            return ("moe",) * self.num_layers
        return ("attn",) * self.num_layers

    @property
    def param_count(self) -> int:
        """Approximate parameter count (for roofline MODEL_FLOPS)."""
        p = 0
        embed = self.vocab_size * self.d_model
        p += embed
        if not self.tie_embeddings:
            p += embed
        for kind in self.attn_layers:
            if kind in ("attn", "moe"):
                q = self.d_model * self.num_heads * self.head_dim
                kv = 2 * self.d_model * self.num_kv_heads * self.head_dim
                o = self.num_heads * self.head_dim * self.d_model
                p += q + kv + o
            if kind == "attn":
                p += 3 * self.d_model * self.d_ff
            elif kind == "moe":
                p += 3 * self.d_model * self.d_ff * self.num_experts
                p += self.d_model * self.num_experts  # router
                if self.shared_expert:
                    p += 3 * self.d_model * self.d_ff
            elif kind == "ssm":
                d_inner = self.ssm_expand * self.d_model
                nheads = d_inner // self.ssm_head_dim
                in_proj = self.d_model * (2 * d_inner + 2 * self.ssm_state + nheads)
                p += in_proj + d_inner * self.d_model
            elif kind == "rglru":
                w = self.lru_width or self.d_model
                p += 2 * self.d_model * w + w * self.d_model + 3 * w
                p += 3 * self.d_model * self.d_ff  # griffin blocks carry an MLP too
        # hybrid local-attn layers also carry an MLP; handled above via "attn"
        return p

    @property
    def active_param_count(self) -> int:
        """Active params per token (MoE: only top_k (+shared) experts)."""
        if self.num_experts == 0:
            return self.param_count
        dense_like = self.param_count
        dense_like -= 3 * self.d_model * self.d_ff * self.num_experts * self.num_layers
        active = self.top_k + (1 if self.shared_expert else 0)
        dense_like += 3 * self.d_model * self.d_ff * active * self.num_layers
        return dense_like

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: 2 layers, d_model<=512, <=4 experts."""
        d_model = min(self.d_model, 256)
        num_heads = min(self.num_heads, 4) if self.num_heads else 0
        num_kv = min(self.num_kv_heads, num_heads) if self.num_kv_heads else 0
        head_dim = 32 if self.head_dim else 0
        updates = dict(
            name=self.name + "-reduced",
            num_layers=2,
            d_model=d_model,
            num_heads=num_heads,
            num_kv_heads=max(num_kv, 1) if num_heads else 0,
            head_dim=head_dim,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            num_experts=min(self.num_experts, 4) if self.num_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            capacity_factor=8.0 if self.num_experts else self.capacity_factor,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_state else 64,
            ssm_chunk=16 if self.ssm_state else 64,
            lru_width=min(self.lru_width, d_model) if self.lru_width else 0,
            window=min(self.window, 64) if self.window else 0,
            sliding_window=64,
            mm_embed_dim=min(self.mm_embed_dim, 64) if self.mm_embed_dim else 0,
            mrope_sections=(8, 4, 4) if self.mrope_sections else (),
            block_pattern=self.block_pattern,
            dtype="float32",
        )
        return dataclasses.replace(self, **updates)


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}
