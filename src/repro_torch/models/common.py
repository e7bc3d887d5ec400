"""Shared model components: norms, RoPE / M-RoPE, SwiGLU, initializers."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.kernels.ops import as_placements, contiguous_grads
from repro_torch.models.hooks import constrain


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


# ---------------------------------------------------------------- DTensor helpers
def lookup(table, tokens):
    """``table[tokens]``: rows (V,d) gathered for tokens of any shape. On a
    DTensor it runs through ``local_map``: a rank whose vocab rows are a
    shard gathers the tokens in its range and zeros for the rest, a
    partial sum over the vocab ranks (a vocab-parallel embedding); a batch
    shard of the tokens carries through, the table's gradient a partial
    sum there."""
    if not isinstance(table, DTensor):
        return table[tokens.long()]
    mesh = table.device_mesh
    t_pl, k_pl, y_pl, t_grad = [], [], [], []
    tok_pl = tokens.placements if isinstance(tokens, DTensor) else (Replicate(),) * mesh.ndim
    vocab_dims = [i for i, p in enumerate(table.placements)
                  if p == Shard(0) and mesh.size(i) > 1]
    for i, (tp, kp) in enumerate(zip(table.placements, tok_pl)):
        if i in vocab_dims:
            t_pl.append(tp), k_pl.append(Replicate()), y_pl.append(Partial())
            t_grad.append(tp)
        elif kp == Shard(0):
            t_pl.append(Replicate()), k_pl.append(kp), y_pl.append(Shard(0))
            t_grad.append(Partial())
        else:
            t_pl.append(Replicate()), k_pl.append(Replicate()), y_pl.append(Replicate())
            t_grad.append(Replicate())

    def local(tok, rows):
        tok = tok.long()
        if not vocab_dims:
            return rows[tok]
        start = 0
        for i in vocab_dims:
            start = start * mesh.size(i) + mesh.get_local_rank(i)
        start *= rows.shape[0]
        idx = tok - start
        inside = (idx >= 0) & (idx < rows.shape[0])
        out = rows[torch.where(inside, idx, 0)]
        return torch.where(inside[..., None], out, torch.zeros((), dtype=out.dtype,
                                                              device=out.device))
    fn = local_map(local, out_placements=y_pl, in_placements=(tuple(k_pl), tuple(t_pl)),
                   in_grad_placements=(tuple(k_pl), tuple(t_grad)), device_mesh=mesh)
    return fn(as_placements(tokens, mesh, k_pl), as_placements(table, mesh, t_pl))


def time_pad(x, k):
    """x (B,S,C) with k - 1 zero steps before its first: ``F.pad`` along S.
    On a DTensor through ``local_map`` on each rank's batch rows and
    channels (a shard of S gathered first)."""
    if not isinstance(x, DTensor):
        return F.pad(x, (0, 0, k - 1, 0))
    mesh = x.device_mesh
    pl = tuple(p if p in (Shard(0), Shard(2)) else Replicate() for p in x.placements)
    fn = local_map(lambda t: F.pad(t, (0, 0, k - 1, 0)), out_placements=list(pl),
                   in_placements=(pl,), device_mesh=mesh)
    return fn(as_placements(x, mesh, pl))


def channel_conv(conv, xs, w, b, s):
    """``conv(xs, w, b, s)``, a causal depthwise convolution of xs (B,S,C)
    by w (K,C) and b (C,). On a DTensor it runs through ``local_map``, per
    mesh dim: where w's channels are sharded each rank convolves its
    channels, else a batch shard of xs carries through (w's and b's
    gradients partial sums there); any other shard of xs is gathered
    first. (Left to DTensor, the shifted slices and sums leave a gradient
    sharded on the sequence, which later products plan slowly.)"""
    if not isinstance(xs, DTensor):
        return conv(xs, w, b, s)
    mesh = xs.device_mesh
    x_pl, w_pl, b_pl, w_grad, b_grad = [], [], [], [], []
    for xp, wp in zip(xs.placements, w.placements):
        if wp == Shard(1):
            x_pl.append(Shard(2)), w_pl.append(wp), b_pl.append(Shard(0))
            w_grad.append(wp), b_grad.append(Shard(0))
        elif xp == Shard(0):
            x_pl.append(xp), w_pl.append(Replicate()), b_pl.append(Replicate())
            w_grad.append(Partial()), b_grad.append(Partial())
        else:
            x_pl.append(Replicate()), w_pl.append(Replicate()), b_pl.append(Replicate())
            w_grad.append(Replicate()), b_grad.append(Replicate())
    x_pl, w_pl, b_pl = tuple(x_pl), tuple(w_pl), tuple(b_pl)
    fn = local_map(lambda xl, wl, bl: conv(*contiguous_grads(xl, wl, bl), s),
                   out_placements=list(x_pl), in_placements=(x_pl, w_pl, b_pl),
                   in_grad_placements=(x_pl, tuple(w_grad), tuple(b_grad)),
                   device_mesh=mesh)
    return fn(as_placements(xs, mesh, x_pl), as_placements(w, mesh, w_pl),
              as_placements(b, mesh, b_pl))


# ---------------------------------------------------------------- norms
def rms_norm(x, scale, eps=1e-6, stat_axes=None):
    """``stat_axes``: the logical axes of the mean square (one per dim of
    x), for ``constrain`` where x's normed dim may be sharded: its sum is
    then completed across the shards there."""
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    if stat_axes is not None:
        var = constrain(var, stat_axes)
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
