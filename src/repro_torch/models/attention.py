"""GQA attention projections (the paged runner's share of
``repro/models/attention.py``).

``attn_context``, ``attn_decode`` and the ring-buffer cache are not ported
yet: the paged runner attends through ``repro_torch.kernels`` instead.
"""
from __future__ import annotations

import torch

from repro_torch.models.common import apply_rope, dense_init, rms_norm


def attn_init(gen: torch.Generator, cfg, dtype, lead=()):
    """Attention weights; ``lead`` prepends a stacked-layer axis."""
    d, hq, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    lead = tuple(lead)
    p = {
        "wq": dense_init(gen, lead + (d, hq, hd), d, dtype),
        "wk": dense_init(gen, lead + (d, hkv, hd), d, dtype),
        "wv": dense_init(gen, lead + (d, hkv, hd), d, dtype),
        "wo": dense_init(gen, lead + (hq, hd, d), hq * hd, dtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(lead + (hd,), dtype=dtype, device=gen.device)
        p["k_norm"] = torch.ones(lead + (hd,), dtype=dtype, device=gen.device)
    return p


def _qkv(params, cfg, x, cos, sin):
    """x (B,S,d) -> q (B,S,Hq,hd), k/v (B,S,Hkv,hd): projections, qk-norm
    over head_dim, then RoPE. Query head h reads kv head h // (Hq/Hkv)."""
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"])
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm"], cfg.norm_eps)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    return q, k, v
