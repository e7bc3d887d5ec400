"""GShard-style capacity-factor routed MoE (top-k, optional shared expert).

The port of ``repro/models/moe.py``. Tokens are processed in groups of at
most 256 so the dispatch/combine tensors stay O(T * G * top_k) instead of
O(T * E * global_capacity). Routing runs in float32; the expert products
are the reference's four einsums, written as batched products over the
expert axis whose right operand is the stored weight itself (E, d, ff) or
(E, ff, d), so no expert weight is copied. Every expert's weights are read
whatever the capacity, as in the reference's dense dispatch.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.common import dense_init, swiglu, swiglu_init
from repro_torch.models.hooks import constrain

GROUP = 256


def moe_init(gen: torch.Generator, cfg, dtype, lead=()):
    """Router (float32), stacked experts and the optional shared expert;
    ``lead`` prepends a stacked-layer axis."""
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    p = {
        "router": dense_init(gen, (d, e), d, torch.float32, lead),
        "we1": dense_init(gen, (e, d, ff), d, dtype, lead),
        "we3": dense_init(gen, (e, d, ff), d, dtype, lead),
        "we2": dense_init(gen, (e, ff, d), ff, dtype, lead),
    }
    if cfg.shared_expert:
        p["shared"] = swiglu_init(gen, d, ff, dtype, lead)
    return p


def _route(gates, top_k, capacity):
    """gates: (n, G, E) fp32 softmax probs.

    Returns dispatch (n,G,E,C) in gates.dtype and combine (n,G,E,C).
    Sequential top-k assignment with per-expert capacity (GShard): choice k
    of every token is placed after all earlier choices of the group, in
    token order within the choice; ties go to the lowest expert index
    (``torch.argmax`` returns the first maximum)."""
    n, g, e = gates.shape
    dt = gates.dtype
    remaining = gates
    # laid out as gates (on a mesh ``new_zeros`` would make each rank a
    # whole replicated copy); dispatch and combine start at the first choice
    base = torch.zeros_like(gates[:, :1], dtype=torch.int32)   # tokens already in each expert
    sel_gate_sum = torch.zeros_like(gates[..., :1])
    dispatch = combine = None
    for _ in range(top_k):
        idx = torch.argmax(remaining, dim=-1)                       # (n,G)
        onehot_i = F.one_hot(idx, e).to(torch.int32)                # (n,G,E)
        onehot = onehot_i.to(dt)
        pos = torch.cumsum(onehot_i, dim=1, dtype=torch.int32) - 1 + base
        base = base + onehot_i.sum(dim=1, keepdim=True, dtype=torch.int32)
        pos_tok = (pos * onehot_i).sum(dim=-1, dtype=torch.int32)  # (n,G)
        fits = (pos_tok < capacity).to(dt)
        slot = F.one_hot(torch.clamp(pos_tok, max=capacity - 1).long(),
                         capacity).to(dt)                           # (n,G,C)
        d_k = onehot[..., None] * slot[..., None, :] * fits[..., None, None]
        gate_val = torch.sum(gates * onehot, dim=-1, keepdim=True)  # (n,G,1)
        c_k = d_k * gate_val[..., None]
        dispatch = d_k if dispatch is None else dispatch + d_k
        combine = c_k if combine is None else combine + c_k
        sel_gate_sum = sel_gate_sum + gate_val * fits[..., None]
        remaining = remaining * (1.0 - onehot)
    combine = combine / torch.clamp(sel_gate_sum[..., None], min=1e-9)
    return dispatch, combine


def moe_apply(params, cfg, x):
    """x: (B, S, d) -> (B, S, d). Every row takes part in routing, padded
    rows of the caller's batch included: they join the groups and take
    capacity exactly as in the reference."""
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    group = min(t, GROUP)
    pad = (-t) % group
    if pad:
        xt = torch.cat([xt, xt.new_zeros((pad, d))], dim=0)
    n = xt.shape[0] // group
    xg = xt.reshape(n, group, d)
    xg = constrain(xg, ("batch", None, None))

    logits = xg.float() @ params["router"]                          # (n,G,E)
    gates = torch.softmax(logits, dim=-1)
    e = cfg.num_experts
    capacity = max(int(math.ceil(group * cfg.capacity_factor * cfg.top_k / e)), 1)
    dispatch, combine = _route(gates, cfg.top_k, capacity)
    dispatch = dispatch.to(x.dtype)
    combine = combine.to(x.dtype)

    # "ngec,ngd->necd": (n, E*C, G) @ (n, G, d), then experts leading
    expert_in = dispatch.reshape(n, group, e * capacity).transpose(1, 2) @ xg
    # laid out experts first, (E, n, C, d), where JAX's is (n, E, C, d)
    expert_in = constrain(expert_in.reshape(n, e, capacity, d).transpose(0, 1),
                          ("experts", "batch", None, None))
    expert_in = expert_in.reshape(e, n * capacity, d)
    # "necd,edf->necf" twice and "necf,efd->necd": (E, n*C, .) @ the weight
    h = F.silu(expert_in @ params["we1"]) * (expert_in @ params["we3"])
    expert_out = (h @ params["we2"]).reshape(e, n, capacity, d).transpose(0, 1)
    # "ngec,necd->ngd": (n, G, E*C) @ (n, E*C, d)
    out = combine.reshape(n, group, e * capacity) @ \
        expert_out.reshape(n, e * capacity, d)

    out = out.reshape(-1, d)
    if pad:
        out = out[:t]
    out = out.reshape(b, s, d)
    if cfg.shared_expert:
        out = out + swiglu(params["shared"], x)
    return out
