"""RecurrentGemma / Griffin RG-LRU recurrent block [arXiv:2402.19427].

The port of ``repro/models/rglru.py``. Recurrence: h_t = a_t * h_{t-1} +
sqrt(1 - a_t^2) * (i_t * x_t), with a_t = exp(-c * softplus(Lambda) * r_t);
gates r/i are per-channel diagonal projections of the conv output. Prefill
runs the recurrence through ``repro_torch.kernels.ops.rglru_scan`` (the
CUDA kernel on the card, the token-by-token plain version on the CPU) where
JAX uses an associative scan: the same function. Decode is a single step.
The temporal-mixing branch is gated by a GeLU branch (Griffin gated
recurrent block), in the tanh form that ``jax.nn.gelu`` defaults to. Both
functions build new state tensors and write into none they were given.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.models.common import dense_init

C_FACTOR = 8.0


def rglru_width(cfg):
    return cfg.lru_width or cfg.d_model


def rglru_init(gen: torch.Generator, cfg, dtype, lead=()):
    """The JAX layout, with float32 ``lam``, ``wr``, ``br``, ``wi`` and
    ``bi`` in any model dtype. ``lead`` prepends a stacked-layer axis."""
    d = cfg.d_model
    w = rglru_width(cfg)
    lead = tuple(lead)

    def full(value, dt=torch.float32):
        return torch.full(lead + (w,), value, dtype=dt, device=gen.device)
    return {
        "wx": dense_init(gen, (d, w), d, dtype, lead),
        "wg": dense_init(gen, (d, w), d, dtype, lead),
        "conv_w": dense_init(gen, (cfg.ssm_conv, w), cfg.ssm_conv, dtype, lead),
        "conv_b": full(0.0, dtype),
        "lam": full(2.0),                  # softplus(2) ~ 2.1
        "wr": full(1.0),
        "br": full(0.0),
        "wi": full(1.0),
        "bi": full(0.0),
        "wo": dense_init(gen, (w, d), w, dtype, lead),
    }


def _gates(params, x32):
    r = torch.sigmoid(x32 * params["wr"] + params["br"])
    i = torch.sigmoid(x32 * params["wi"] + params["bi"])
    log_a = -C_FACTOR * F.softplus(params["lam"]) * r
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), 1e-12, 1.0))
    return a, mult * i * x32


def rglru_context(params, cfg, x, *, return_cache=False):
    """Train / prefill. x: (B,S,d) -> (B,S,d); cache = (conv, h) final states."""
    bsz, s, _ = x.shape
    xa = x @ params["wx"]                                    # (B,S,W)
    k = params["conv_w"].shape[0]
    xa_pad = F.pad(xa, (0, 0, k - 1, 0))
    conv = sum(xa_pad[:, i: i + s] * params["conv_w"][i][None, None]
               for i in range(k)) + params["conv_b"][None, None]

    a, b = _gates(params, conv.float())                      # (B,S,W) each
    h = kops.rglru_scan(a, b)
    gate = F.gelu(x @ params["wg"], approximate="tanh")
    out = (h.to(x.dtype) * gate) @ params["wo"]
    cache = None
    if return_cache:
        cache = {"conv": xa_pad[:, -k:].to(x.dtype), "h": h[:, -1]}
    return out, cache


def rglru_decode(params, cfg, x, cache):
    """One-token decode. x: (B,1,d); cache conv (B,K,W), h (B,W) fp32."""
    xa = x[:, 0] @ params["wx"]                              # (B,W)
    conv_state = torch.cat([cache["conv"][:, 1:], xa[:, None]], dim=1)
    conv = torch.sum(conv_state * params["conv_w"][None], dim=1) + params["conv_b"][None]
    a, b = _gates(params, conv.float())
    h = a * cache["h"] + b
    gate = F.gelu(x[:, 0] @ params["wg"], approximate="tanh")
    out = (h.to(x.dtype) * gate) @ params["wo"]
    return out[:, None], {"conv": conv_state, "h": h}
