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
def dense_init(gen: torch.Generator, shape, in_axis_size, dtype, lead=()):
    """Normal weights of ``lead + shape`` scaled by 1/sqrt(in_axis_size).
    ``lead`` (the stacked-layer axes) is drawn one layer at a time in
    float32 and written into a tensor of ``dtype``: the float32 temporary
    is one layer's (805 MB for qwen3-moe's ``we1``), not the stack's."""
    scale = 1.0 / np.sqrt(max(in_axis_size, 1))
    lead, shape = tuple(lead), tuple(shape)
    out = torch.empty(lead + shape, dtype=dtype, device=gen.device)
    for idx in np.ndindex(*lead):          # a single () when there is no lead
        w = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
        out[idx] = w.mul_(scale)
    return out


def embed_init(gen: torch.Generator, shape, dtype):
    w = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return w.mul_(0.02).to(dtype)


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


def default_positions(batch, seq, mrope=False, offset=0, device="cpu"):
    pos = torch.arange(seq, dtype=torch.int32, device=device)[None, :] + offset
    pos = pos.expand(batch, seq)
    if mrope:
        pos = pos[None].expand(3, batch, seq)
    return pos


# ---------------------------------------------------------------- MLP
def swiglu_init(gen: torch.Generator, d_model, d_ff, dtype, lead=()):
    """``lead`` prepends a stacked-layer axis."""
    return {
        "w1": dense_init(gen, (d_model, d_ff), d_model, dtype, lead),
        "w3": dense_init(gen, (d_model, d_ff), d_model, dtype, lead),
        "w2": dense_init(gen, (d_ff, d_model), d_ff, dtype, lead),
    }


def swiglu(params, x):
    h = F.silu(x @ params["w1"]) * (x @ params["w3"])
    return h @ params["w2"]
