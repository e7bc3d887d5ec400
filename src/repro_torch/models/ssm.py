"""Mamba-2 SSD (state-space duality) block [arXiv:2405.21060].

The port of ``repro/models/ssm.py``: chunked SSD scan for prefill
(quadratic intra-chunk, linear inter-chunk recurrence) and O(1)-state
decode. ngroups=1 (B/C shared across heads), matching the 1.3B config. The
scan goes through ``repro_torch.kernels.ops.ssd_scan``: the CUDA kernel on
the card, the plain chunked version on the CPU. Every function is
functional, as in JAX: it builds new state tensors and writes into none it
was given, so a state may be shared with a snapshot safely.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.models.common import dense_init, rms_norm


def ssm_dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    nheads = d_inner // cfg.ssm_head_dim
    return d_inner, nheads


def ssm_init(gen: torch.Generator, cfg, dtype, lead=()):
    """The JAX layout: the in-projection split per consumer (z, x, B, C,
    dt), separate convolutions for x and for B/C, and float32 ``A_log``,
    ``D`` and ``dt_bias`` in any model dtype. ``lead`` prepends a
    stacked-layer axis."""
    d = cfg.d_model
    d_inner, nheads = ssm_dims(cfg)
    n = cfg.ssm_state
    lead = tuple(lead)
    dev = gen.device

    def full(shape, value, dt):
        return torch.full(lead + shape, value, dtype=dt, device=dev)
    return {
        "z_proj": dense_init(gen, (d, d_inner), d, dtype, lead),
        "x_proj": dense_init(gen, (d, d_inner), d, dtype, lead),
        "b_proj": dense_init(gen, (d, n), d, dtype, lead),
        "c_proj": dense_init(gen, (d, n), d, dtype, lead),
        "dt_proj": dense_init(gen, (d, nheads), d, dtype, lead),
        "conv_x": dense_init(gen, (cfg.ssm_conv, d_inner), cfg.ssm_conv, dtype, lead),
        "conv_bc": dense_init(gen, (cfg.ssm_conv, 2 * n), cfg.ssm_conv, dtype, lead),
        "conv_x_b": full((d_inner,), 0.0, dtype),
        "conv_bc_b": full((2 * n,), 0.0, dtype),
        "A_log": full((nheads,), 0.0, torch.float32),    # A = -exp(A_log) = -1
        "D": full((nheads,), 1.0, torch.float32),
        "dt_bias": full((nheads,), 0.0, torch.float32),
        "norm": full((d_inner,), 1.0, dtype),
        "out_proj": dense_init(gen, (d_inner, d), d_inner, dtype, lead),
    }


def _split_proj(params, cfg, x):
    z = x @ params["z_proj"]
    xs = x @ params["x_proj"]
    bc = torch.cat([x @ params["b_proj"], x @ params["c_proj"]], dim=-1)
    dt = x @ params["dt_proj"]
    return z, xs, bc, dt


def _postprocess(params, cfg, y, x_in, z):
    d_inner, _ = ssm_dims(cfg)
    y = y + params["D"][None, None, :, None].float() * x_in.float()
    y = y.reshape(*y.shape[:-2], d_inner).to(z.dtype)
    y = rms_norm(y * F.silu(z), params["norm"], cfg.norm_eps)
    return y @ params["out_proj"]


def _causal_conv(xs, w, b, s):
    k = w.shape[0]
    pad = F.pad(xs, (0, 0, k - 1, 0))
    out = sum(pad[:, i: i + s] * w[i][None, None] for i in range(k))
    return F.silu(out + b[None, None])


def _causal_conv_with_state(xs, w, b, s, init):
    """init: (B, K, C) raw inputs preceding x (init[:, -1] = newest)."""
    k = w.shape[0]
    pad = torch.cat([init[:, -(k - 1):].to(xs.dtype), xs], dim=1)
    out = sum(pad[:, i: i + s] * w[i][None, None] for i in range(k))
    return F.silu(out + b[None, None])


def ssm_context(params, cfg, x, *, return_cache=False, initial=None,
                boundary_states=False):
    """Train / prefill. x: (B,S,d). Cache = final (conv, ssd) states.

    ``initial``: optional {"conv": (B,K,C), "ssd": (B,H,P,N)} resume state
    (Echo's state-snapshot prefix caching for attention-free archs).
    ``boundary_states=True`` additionally returns the SSD state after every
    ssm_chunk boundary (S must then be a chunk multiple) plus the raw conv
    inputs, so the engine can snapshot block-granular states.
    """
    bsz, s, _ = x.shape
    d_inner, nheads = ssm_dims(cfg)
    n = cfg.ssm_state
    z, xs, bc, dt = _split_proj(params, cfg, x)
    k = params["conv_x"].shape[0]
    if initial is not None:
        init_x = initial["conv"][..., :d_inner]
        init_bc = initial["conv"][..., d_inner:]
        conv_x = _causal_conv_with_state(xs, params["conv_x"],
                                         params["conv_x_b"], s, init_x)
        conv_bc = _causal_conv_with_state(bc, params["conv_bc"],
                                          params["conv_bc_b"], s, init_bc)
    else:
        conv_x = _causal_conv(xs, params["conv_x"], params["conv_x_b"], s)
        conv_bc = _causal_conv(bc, params["conv_bc"], params["conv_bc_b"], s)
    x_in = conv_x.reshape(bsz, s, nheads, cfg.ssm_head_dim)
    b_mat = conv_bc[..., :n]
    c_mat = conv_bc[..., n:]

    dt = F.softplus(dt.float() + params["dt_bias"][None, None])
    a = -torch.exp(params["A_log"])                          # (H,)
    pad = (-s) % cfg.ssm_chunk
    if pad:
        # dt=0 on padding => decay 1 and zero input: identity on the state
        x_in_p = F.pad(x_in, (0, 0, 0, 0, 0, pad))
        b_p = F.pad(b_mat, (0, 0, 0, pad))
        c_p = F.pad(c_mat, (0, 0, 0, pad))
        dt_p = F.pad(dt, (0, 0, 0, pad))
    else:
        x_in_p, b_p, c_p, dt_p = x_in, b_mat, c_mat, dt
    init_ssd = initial["ssd"] if initial is not None else None
    res = kops.ssd_scan(
        x_in_p.float() * dt_p[..., None], dt_p * a[None, None], b_p, c_p,
        chunk=cfg.ssm_chunk, initial_state=init_ssd,
        return_all_states=boundary_states)
    if boundary_states:
        y, final_state, all_states = res
    else:
        y, final_state = res
    if pad:
        y = y[:, :s]
    out = _postprocess(params, cfg, y, x_in, z)
    xbc = torch.cat([xs, bc], dim=-1)                     # raw conv inputs
    if initial is not None:
        xbc_full = torch.cat(
            [initial["conv"][:, -(k - 1):].to(xbc.dtype), xbc], dim=1)
    else:
        xbc_full = F.pad(xbc, (0, 0, k - 1, 0))
    cache = None
    if return_cache:
        cache = {"conv": xbc_full[:, -k:].to(x.dtype),
                 "ssd": final_state.float()}
    if boundary_states:
        # conv raw-input window ending at each chunk boundary i:
        # xbc_full[:, (i+1)*chunk - 1 : (i+1)*chunk - 1 + k]  (k-1 lead + k..)
        nc = s // cfg.ssm_chunk
        idx = (torch.arange(1, nc + 1, device=x.device) * cfg.ssm_chunk)[:, None] + \
            torch.arange(k, device=x.device)[None, :] - 1    # (nc, K)
        conv_bounds = xbc_full[:, idx.reshape(-1)]
        conv_bounds = conv_bounds.reshape(xbc.shape[0], nc, k, -1)
        return out, cache, {"ssd": all_states, "conv": conv_bounds}
    return out, cache


def ssm_decode(params, cfg, x, cache):
    """One-token decode. x: (B,1,d); cache conv (B,K,C), ssd (B,H,P,N)."""
    bsz = x.shape[0]
    d_inner, nheads = ssm_dims(cfg)
    n = cfg.ssm_state
    z, xs, bc, dt = _split_proj(params, cfg, x[:, 0])        # (B, ...)
    xbc = torch.cat([xs, bc], dim=-1)
    conv_state = torch.cat([cache["conv"][:, 1:], xbc[:, None]], dim=1)
    conv_w = torch.cat([params["conv_x"], params["conv_bc"]], dim=-1)
    conv_b = torch.cat([params["conv_x_b"], params["conv_bc_b"]], dim=-1)
    conv = torch.sum(conv_state * conv_w[None], dim=1) + conv_b[None]
    conv = F.silu(conv)
    x_in = conv[..., :d_inner].reshape(bsz, nheads, cfg.ssm_head_dim)
    b_mat = conv[..., d_inner: d_inner + n].float()
    c_mat = conv[..., d_inner + n:].float()

    dt = F.softplus(dt.float() + params["dt_bias"][None])   # (B,H)
    a = -torch.exp(params["A_log"])
    decay = torch.exp(dt * a[None])                          # (B,H)
    xbar = x_in.float() * dt[..., None]                      # (B,H,P)
    h_new = (cache["ssd"] * decay[..., None, None]
             + xbar[..., None] * b_mat[:, None, None, :])    # (B,H,P,N)
    y = torch.einsum("bhpn,bn->bhp", h_new, c_mat)           # (B,H,P)
    out = _postprocess(params, cfg, y[:, None], x_in[:, None], z[:, None])
    return out, {"conv": conv_state, "ssd": h_new}
