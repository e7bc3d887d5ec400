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
leaf. Where ZeRO-1 moments split a parameter's own shard further over the
data ranks (the ZeRO ranks), the update stays inside that shard, as XLA's
does in the reference: the gradient's pending sum over those ranks is
reduce-scattered straight into the moments' layout (one functional
collective over the ZeRO ranks' group), the parameter's slice in that
layout is a local cut, and the updated slices are all-gathered back into
the parameter's shard. Any other gradient is moved to its moments' layout
by DTensor. The global norm sums each leaf's local squares and then those
of one sharding layout across the ranks in one all-reduce.
"""
from __future__ import annotations

import itertools
import weakref
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate

from repro_torch.launch.mesh import shard_blocks
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
            dims = tuple(d for d, p in enumerate(x.placements) if not p.is_replicate())
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


class _Zero(NamedTuple):
    """Where a leaf's ZeRO-1 moments cut its parameter's own shard: the
    ZeRO ranks are those of mesh dims ``mesh_dims``; the cut is along
    tensor dim ``dim`` into as many equal chunks as there are ZeRO ranks;
    ``chunks[r]`` is the chunk the ZeRO rank of group rank ``r`` holds,
    ``own`` this rank's group rank, ``group`` the ZeRO ranks' process
    group (None for one rank)."""
    mesh_dims: tuple
    dim: int
    chunks: tuple
    own: int
    group: object


# per mesh (by id, with a weak reference that tells a new mesh from a dead
# one): the flattened groups of its mesh dims. Slicing a mesh runs tensor
# ops (which the dry run would count every step) and a new group is a
# collective, so each is made once.
_GROUPS = {}


def _zero_group(mesh, dims):
    """The process group of the mesh dims ``dims`` (in mesh order): the
    mesh dim's own, or their flattened mesh's."""
    if len(dims) == 1:
        return mesh.get_group(dims[0])
    ref, groups = _GROUPS.get(id(mesh), (None, None))
    if ref is None or ref() is not mesh:
        groups = {}
        _GROUPS[id(mesh)] = (weakref.ref(mesh), groups)
    if dims not in groups:
        names = tuple(mesh.mesh_dim_names[i] for i in dims)
        groups[dims] = mesh[names]._flatten().get_group()
    return groups[dims]


def _sharded(pl, dim=None) -> bool:
    return not (pl.is_replicate() or pl.is_partial()) and (dim is None or pl.dim == dim)


def _zero_plan(p, m) -> Optional[_Zero]:
    """The ZeRO-1 split of parameter ``p``'s shard by its moment ``m``: the
    mesh dims where the layouts differ (``p`` replicated there, ``m``
    sharding one tensor dim further) are the ZeRO ranks, and each holds
    one chunk of the shard. None where ``m`` is laid out as ``p``."""
    pp, mp = tuple(p.placements), tuple(m.placements)
    zero = tuple(i for i, (a, b) in enumerate(zip(pp, mp)) if a != b)
    if not zero:
        return None
    dims = {mp[i].dim for i in zero if _sharded(mp[i])}
    if len(dims) != 1 or any(not pp[i].is_replicate() for i in zero):
        raise ValueError(f"moments laid out {mp} do not split the parameter's shard {pp}")
    dim = dims.pop()
    mesh = m.device_mesh
    shape, coord = tuple(mesh.shape), mesh.get_coordinate()
    total = int(np.prod([shape[i] for i, pl in enumerate(mp) if _sharded(pl, dim)]))
    mine = shard_blocks(pp, shape, coord, dim, total)
    chunks = []
    for zc in itertools.product(*(range(shape[i]) for i in zero)):   # group order
        at = list(coord)
        for i, c in zip(zero, zc):
            at[i] = c
        block, = shard_blocks(mp, shape, at, dim, total)
        if block not in mine:
            raise ValueError(f"moments laid out {mp} leave the parameter's shard {pp}")
        chunks.append(mine.index(block))
    own = int(np.ravel_multi_index([coord[i] for i in zero], [shape[i] for i in zero]))
    group = None
    if len(chunks) > 1:
        group = _zero_group(mesh, zero)
        if dist.get_rank(group) != own:
            raise RuntimeError(f"the ZeRO group of mesh dims {zero} is not in mesh order")
    return _Zero(zero, dim, tuple(chunks), own, group)


def _chunk(x, plan, r):
    size = x.shape[plan.dim] // len(plan.chunks)
    return x.narrow(plan.dim, plan.chunks[r] * size, size)


def _grad_to_zero(g, p, m, plan):
    """A DTensor gradient of ``p`` in the layout of its moment ``m``, which
    splits ``p``'s shard by ``plan``: a pending sum over the ZeRO ranks is
    reduce-scattered into it, a replicated value cut locally."""
    mesh, gp = m.device_mesh, tuple(g.placements)
    pending = all(gp[i].is_partial() and gp[i].reduce_op == "sum" for i in plan.mesh_dims)
    want = tuple(gp[i] if pending and i in plan.mesh_dims else pl
                 for i, pl in enumerate(p.placements))
    if gp != want:
        g = g.redistribute(mesh, want)
    gl = g.to_local()
    n = len(plan.chunks)
    if pending and n > 1:
        # the chunks in group order, stacked along dim 0: rank r's is the r-th
        send = torch.cat([_chunk(gl, plan, r) for r in range(n)], dim=0)
        out = torch.ops._c10d_functional.reduce_scatter_tensor(
            send, "sum", n, plan.group.group_name)
        local = torch.ops._c10d_functional.wait_tensor(out)
    else:
        local = _chunk(gl, plan, plan.own)
    return DTensor.from_local(local, mesh, m.placements, run_check=False, shape=g.shape,
                              stride=g.stride())


def _gather_into(local, shard, plan):
    """Writes ``shard``, this rank's updated chunk of the parameter's own
    shard ``local``, and the other ZeRO ranks' chunks, all-gathered over
    their group, into ``local``."""
    n = len(plan.chunks)
    out = torch.ops._c10d_functional.all_gather_into_tensor(shard, n, plan.group.group_name)
    got = torch.ops._c10d_functional.wait_tensor(out)
    rows = shard.shape[0]
    for r in range(n):
        _chunk(local, plan, r).copy_(got[r * rows:(r + 1) * rows])


@torch.no_grad()
def adamw_update(params, grads, state: AdamWState, *, lr,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, clip: float = 1.0):
    """One AdamW step of ``params`` by ``grads`` (a tree like params), in
    place. Returns (params, new state, gnorm): gnorm is the global norm of
    the gradients before clipping, a 0-d float32 tensor."""
    ps, ms, vs = tree_leaves(params), tree_leaves(state.m), tree_leaves(state.v)
    plans = [_zero_plan(p, m) if isinstance(p, DTensor) else None for p, m in zip(ps, ms)]
    gs = []
    for g, p, m, plan in zip(tree_leaves(grads), ps, ms, plans):
        if plan is not None:
            g = _grad_to_zero(g, p, m, plan)
        elif isinstance(g, DTensor) and tuple(g.placements) != tuple(m.placements):
            g = g.redistribute(m.device_mesh, m.placements)
        gs.append(g)
    gnorm = global_norm(gs)
    scale = torch.clamp(clip / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    f = np.float32
    bc1 = float(f(1.0) - f(b1) ** f(step))
    bc2 = float(f(1.0) - f(b2) ** f(step))
    for p, g, m, v, plan in zip(ps, gs, ms, vs, plans):
        if not isinstance(p, DTensor):
            _update(p.view(-1), g.reshape(-1), m.view(-1), v.view(-1), scale, lr, b1, b2,
                    bc1, bc2, eps, weight_decay)
            continue
        # the rank's chunk of its own shard (a local cut), updated, then
        # gathered back over the ZeRO ranks
        local = p.to_local()
        part = local if plan is None else _chunk(local, plan, plan.own)
        shard = part if part.is_contiguous() else part.contiguous()
        _update(shard.view(-1), g.to_local().reshape(-1), m.to_local().view(-1),
                v.to_local().view(-1), scale, lr, b1, b2, bc1, bc2, eps, weight_decay)
        if plan is not None and plan.group is not None:
            _gather_into(local, shard, plan)
        elif shard is not part:
            part.copy_(shard)
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
