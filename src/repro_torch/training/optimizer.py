"""AdamW + cosine schedule + global-norm clipping, in place on the port's
parameter trees.

The arithmetic of ``repro/training/optimizer.py``: clip by the global
float32 norm; m and v in float32; u = (m/bc1)/(sqrt(v/bc2)+eps) + wd p;
p <- (p32 - lr u) cast back to the parameter's dtype. The schedule and the
bias corrections are computed in float32 as JAX computes them. Unlike the
JAX version, the update is in place, leaf by leaf and within a leaf a
slice at a time, under ``torch.no_grad()``: a functional update at
qwen3-4b's width would copy m and v (35.3 GB) and cast the whole gradient
tree to float32 (17.6 GB), which one card cannot hold. It returns what JAX
returns, ``(params, state, gnorm)``, with ``params`` and the state's m and
v the tensors it was given, updated.

Distributed trees (DTensor leaves, ``repro_torch.launch.sharding``) are
updated a local shard at a time, never through a flat view of the whole
leaf: each gradient is first moved to its moments' layout (with ZeRO-1
moments, a reduce-scatter of the partial sums), the global norm sums each
leaf's local squares and then those of one sharding layout across the
ranks in one all-reduce, and each parameter's updated shard is gathered
back to the parameter's own layout.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Partial, Replicate

from repro_torch.params import tree_leaves, tree_map

# elements of a leaf updated at once: the float32 temporaries of one slice
# (four of them) stay near 1 GB whatever the leaf's size
SLICE = 1 << 26


class AdamWState(NamedTuple):
    step: int              # updates taken
    m: object              # tree like params (float32)
    v: object              # tree like params (float32)


def adamw_init(params) -> AdamWState:
    """Zero moments in float32 beside each parameter, on its device (laid
    out as the parameter, for a DTensor; ZeRO-1 moments come from
    ``repro_torch.launch.sharding.zero1_adamw_init``)."""
    def zeros(p):
        return torch.zeros_like(p, dtype=torch.float32, memory_format=torch.contiguous_format)
    return AdamWState(step=0, m=tree_map(zeros, params), v=tree_map(zeros, params))


def cosine_lr(step, *, peak: float = 3e-4, warmup: int = 100,
              total: int = 10_000, floor_frac: float = 0.1) -> float:
    """Linear warmup to ``peak``, then a cosine down to ``floor_frac`` of
    it at ``total``; in float32, as JAX computes it, returned as a float."""
    f = np.float32
    step = int(step)
    if step < warmup:
        return float(f(peak) * f(step + 1) / f(max(warmup, 1)))
    prog = np.clip(f(step - warmup) / f(max(total - warmup, 1)), f(0.0), f(1.0))
    cos = f((1 - floor_frac) * 0.5) * (f(1.0) + np.cos(f(np.pi) * prog))
    return float(f(peak) * (f(floor_frac) + cos))


def _sum_squares(x) -> torch.Tensor:
    """A plain tensor's float32 squares summed a slice at a time, so its
    float32 copy never exists whole."""
    f = x.reshape(-1)
    return sum((torch.sum(torch.square(f[i:i + SLICE].float()))
                for i in range(0, f.numel(), SLICE)),
               torch.zeros((), dtype=torch.float32, device=x.device))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 squares, a 0-d float32
    tensor on the leaves' device. A DTensor leaf sums its local shard (a
    pending sum gathered first); the leaves of one layout then sum their
    shards' squares across the ranks that shard them, in one all-reduce of
    a vector with an entry per leaf, so each leaf's total is exact and the
    leaves add up in the same order as plain ones."""
    leaves = tree_leaves(tree)
    sq, layouts = [], {}
    for i, x in enumerate(leaves):
        if isinstance(x, DTensor):
            if any(p.is_partial() for p in x.placements):
                x = x.redistribute(x.device_mesh, [Replicate() if p.is_partial() else p
                                                   for p in x.placements])
            dims = tuple(d for d, p in enumerate(x.placements) if p.is_shard())
            if dims:
                layouts.setdefault((x.device_mesh, dims), []).append(i)
            x = x.to_local()
        sq.append(_sum_squares(x))
    for (mesh, dims), idx in layouts.items():
        partial = [Partial() if d in dims else Replicate() for d in range(mesh.ndim)]
        total = DTensor.from_local(torch.stack([sq[i] for i in idx]), mesh, partial,
                                   run_check=False)
        total = total.redistribute(mesh, [Replicate()] * mesh.ndim).to_local()
        for j, i in enumerate(idx):
            sq[i] = total[j]
    return torch.sqrt(torch.sum(torch.stack(sq)))


def _to_layout(g, like):
    """A DTensor gradient on the layout of ``like`` (its moment): pending
    sums reduced, shards cut or gathered as that layout wants."""
    if tuple(g.placements) == tuple(like.placements):
        return g
    return g.redistribute(like.device_mesh, like.placements)


@torch.no_grad()
def adamw_update(params, grads, state: AdamWState, *, lr,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, clip: float = 1.0):
    """One AdamW step of ``params`` by ``grads`` (a tree like params), in
    place. Returns (params, new state, gnorm): gnorm is the global norm of
    the gradients before clipping, a 0-d float32 tensor."""
    ps, ms, vs = tree_leaves(params), tree_leaves(state.m), tree_leaves(state.v)
    gs = [_to_layout(g, m) if isinstance(g, DTensor) else g
          for g, m in zip(tree_leaves(grads), ms)]
    gnorm = global_norm(gs)
    scale = torch.clamp(clip / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    f = np.float32
    bc1 = float(f(1.0) - f(b1) ** f(step))
    bc2 = float(f(1.0) - f(b2) ** f(step))
    for p, g, m, v in zip(ps, gs, ms, vs):
        if not isinstance(p, DTensor):
            _update(p.view(-1), g.reshape(-1), m.view(-1), v.view(-1), scale, lr, b1, b2,
                    bc1, bc2, eps, weight_decay)
            continue
        # the rank's slice of p in its moments' layout (a local cut, no
        # collective), updated, then gathered back to p's own layout
        mesh, layout = m.device_mesh, m.placements
        own = tuple(p.placements) == tuple(layout)
        shard = p.to_local() if own else p.redistribute(mesh, layout).to_local().contiguous()
        _update(shard.view(-1), g.to_local().reshape(-1), m.to_local().view(-1),
                v.to_local().view(-1), scale, lr, b1, b2, bc1, bc2, eps, weight_decay)
        if not own:
            new = DTensor.from_local(shard, mesh, layout, run_check=False, shape=p.shape,
                                     stride=p.stride())
            p.to_local().copy_(new.redistribute(mesh, p.placements).to_local())
    return params, AdamWState(step=step, m=state.m, v=state.v), gnorm


def _update(pf, gf, mf, vf, scale, lr, b1, b2, bc1, bc2, eps, weight_decay):
    """AdamW on flat views, in place on pf, mf and vf, a slice at a time."""
    for i in range(0, pf.numel(), SLICE):
        sl = slice(i, i + SLICE)
        g32 = gf[sl].float() * scale
        mf[sl].mul_(b1).add_(g32, alpha=1 - b1)
        vf[sl].mul_(b2).add_(g32.mul_(g32), alpha=1 - b2)
        u = (mf[sl] / bc1).div_((vf[sl] / bc2).sqrt_().add_(eps))
        p32 = pf[sl].float()
        u.add_(p32, alpha=weight_decay)
        pf[sl].copy_(p32 - u.mul_(lr))
