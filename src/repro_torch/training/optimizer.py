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
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.params import tree_leaves, tree_map

# elements of a leaf updated at once: the float32 temporaries of one slice
# (four of them) stay near 1 GB whatever the leaf's size
SLICE = 1 << 26


class AdamWState(NamedTuple):
    step: int              # updates taken
    m: object              # tree like params (float32)
    v: object              # tree like params (float32)


def adamw_init(params) -> AdamWState:
    """Zero moments in float32 beside each parameter, on its device."""
    zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
    return AdamWState(step=0, m=zeros, v=tree_map(torch.zeros_like, zeros))


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


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 squares, a 0-d float32
    tensor on the leaves' device; a leaf's squares are summed a slice at a
    time, so its float32 copy never exists whole."""
    sq = []
    for x in tree_leaves(tree):
        f = x.reshape(-1)
        sq.append(sum((torch.sum(torch.square(f[i:i + SLICE].float()))
                       for i in range(0, f.numel(), SLICE)),
                      torch.zeros((), dtype=torch.float32, device=x.device)))
    return torch.sqrt(torch.sum(torch.stack(sq)))


@torch.no_grad()
def adamw_update(params, grads, state: AdamWState, *, lr,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, clip: float = 1.0):
    """One AdamW step of ``params`` by ``grads`` (a tree like params), in
    place. Returns (params, new state, gnorm): gnorm is the global norm of
    the gradients before clipping, a 0-d float32 tensor."""
    gnorm = global_norm(grads)
    scale = torch.clamp(clip / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    f = np.float32
    bc1 = float(f(1.0) - f(b1) ** f(step))
    bc2 = float(f(1.0) - f(b2) ** f(step))
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state.m), tree_leaves(state.v)):
        pf, gf, mf, vf = p.view(-1), g.reshape(-1), m.view(-1), v.view(-1)
        for i in range(0, pf.numel(), SLICE):
            sl = slice(i, i + SLICE)
            g32 = gf[sl].float() * scale
            mf[sl].mul_(b1).add_(g32, alpha=1 - b1)
            vf[sl].mul_(b2).add_(g32.mul_(g32), alpha=1 - b2)
            u = (mf[sl] / bc1).div_((vf[sl] / bc2).sqrt_().add_(eps))
            p32 = pf[sl].float()
            u.add_(p32, alpha=weight_decay)
            pf[sl].copy_(p32 - u.mul_(lr))
    return params, AdamWState(step=step, m=state.m, v=state.v), gnorm
