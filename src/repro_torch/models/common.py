"""Shared model components: norms, RoPE / M-RoPE, SwiGLU, initializers."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def dtype_of(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. ``cuda`` must really be there:
    the port never falls back to the CPU behind the caller's back."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {str(dev)!r}")
    return dev


# ---------------------------------------------------------------- init utils
def dense_init(gen: torch.Generator, shape, in_axis_size, dtype):
    scale = 1.0 / np.sqrt(max(in_axis_size, 1))
    w = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return (w * scale).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype):
    w = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return (w * 0.02).to(dtype)


# ---------------------------------------------------------------- norms
def rms_norm(x, scale, eps=1e-6):
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * scale.float()
    return out.to(dt)


# ---------------------------------------------------------------- RoPE
def rope_inv_freq(head_dim, theta):
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))


def rope_angles(positions, head_dim, theta, mrope_sections=()):
    """positions: (B, S) int, or (3, B, S) for M-RoPE.

    Returns (cos, sin) with shape (B, S, head_dim // 2), float32.
    """
    inv_freq = torch.from_numpy(
        rope_inv_freq(head_dim, theta).astype(np.float32)).to(positions.device)
    if positions.dim() == 2:
        ang = positions.float()[..., None] * inv_freq                # (B,S,hd/2)
    else:
        # M-RoPE: half-dim index i belongs to section s(i); use position stream s.
        assert sum(mrope_sections) == head_dim // 2, "mrope sections must cover head_dim/2"
        sec_id = torch.from_numpy(np.concatenate(
            [np.full(n, i, np.int64) for i, n in enumerate(mrope_sections)]
        )).to(positions.device)                                      # (hd/2,)
        pos_per_dim = positions.float()[sec_id]                      # (hd/2,B,S)
        ang = torch.movedim(pos_per_dim, 0, -1) * inv_freq           # (B,S,hd/2)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: (B, S, H, head_dim); cos/sin: (B, S, head_dim//2)."""
    dt = x.dtype
    x = x.float()
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(dt)


# ---------------------------------------------------------------- MLP
def swiglu_init(gen: torch.Generator, d_model, d_ff, dtype, lead=()):
    """``lead`` prepends a stacked-layer axis."""
    lead = tuple(lead)
    return {
        "w1": dense_init(gen, lead + (d_model, d_ff), d_model, dtype),
        "w3": dense_init(gen, lead + (d_model, d_ff), d_model, dtype),
        "w2": dense_init(gen, lead + (d_ff, d_model), d_ff, dtype),
    }


def swiglu(params, x):
    h = F.silu(x @ params["w1"]) * (x @ params["w3"])
    return h @ params["w2"]
