"""Divisibility-aware logical sharding rules, their DTensor placements, and
the dry run's input specs.

The port of ``repro/launch/sharding.py``. Parameters shard on the `model`
axis by name-based rules (Megatron-style tensor parallelism + expert
parallelism); activations and batches shard on (`pod`, `data`). Any dim not
divisible by its mesh axes is replicated, which lets one rule set serve
MQA (kv=1), 24-head MHA, 128-expert MoE etc. without per-arch cases.

The rules (``_PARAM_RULES``, ``_axes_fit``, ``_leaf_spec``) are the
reference's, pure functions of shapes: a spec is a plain tuple with one
entry per tensor dim, None or the tuple of mesh axes that dim shards over
(what ``PartitionSpec`` holds in the JAX package). ``to_placements`` turns
a spec into DTensor placements, one per mesh dim.

**Shard order across several mesh axes.** A dim that a spec shards over
more than one mesh axis is split in the spec's order, major first, as JAX
splits it: ZeRO-1's ``("model", "data", "pod")`` puts the rank at (pod k,
data i, model j) on block ``(j * |data| + i) * |pod| + k``, a slice of its
own `model` shard. DTensor splits a dim in mesh-dim order, (``pod``,)
``data``, ``model``, so ``to_placements`` makes each mesh axis that the spec
lists after axes that come later in the mesh a ``_StridedShard`` whose
split factor is the product of those axes' sizes. ``batch``'s ``("pod",
"data")`` follows the mesh's order and stays plain ``Shard``s. Local shard
shapes are the reference's either way.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication
from torch.distributed.tensor.placement_types import _StridedShard

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.launch.mesh import mesh_sizes
from repro_torch.models import hooks
from repro_torch.models.model import Model
from repro_torch.params import tree_map_with_names
from repro_torch.training.optimizer import AdamWState

# name -> {trailing_ndim: spec_from_end}; 'model' entries are
# divisibility-checked per tensor.
_PARAM_RULES = {
    "embed": {2: ("model", None)},
    "unembed": {2: (None, "model")},
    "mm_proj": {2: (None, None)},
    "wq": {3: (None, "model", None)},
    "wk": {3: (None, "model", None)},
    "wv": {3: (None, "model", None)},
    "wo": {3: ("model", None, None), 2: ("model", None)},   # attn / rglru
    "w1": {2: (None, "model")},
    "w3": {2: (None, "model")},
    "w2": {2: ("model", None)},
    "router": {2: (None, "model")},
    "we1": {3: ("model", None, None)},
    "we3": {3: ("model", None, None)},
    "we2": {3: ("model", None, None)},
    "z_proj": {2: (None, "model")},
    "x_proj": {2: (None, "model")},
    "dt_proj": {2: (None, "model")},
    # b_proj / c_proj / conv_bc replicated (B,C are shared across heads)
    "out_proj": {2: ("model", None)},
    "conv_w": {2: (None, "model")},
    "conv_x": {2: (None, "model")},
    "wx": {2: (None, "model")},
    "wg": {2: (None, "model")},
}

# ZeRO-1: the AdamW moments shard like their parameters plus across these
ZERO_AXES = ("data", "pod")


def _axes_fit(dim: int, axes, mesh) -> Optional[Tuple[str, ...]]:
    """Largest prefix of `axes` whose size product divides `dim`."""
    if isinstance(axes, str):
        axes = (axes,)
    sizes = mesh_sizes(mesh)
    prod = 1
    used = []
    for a in axes:
        if a not in sizes:
            continue
        if dim % (prod * sizes[a]) == 0:
            prod *= sizes[a]
            used.append(a)
        else:
            break
    return tuple(used) if used else None


def _leaf_spec(path_names, leaf, mesh, extra_axes=()) -> tuple:
    """Match on the last path name; stacked (scan) params carry extra
    leading dims, so rules apply to the *trailing* ndim. ``extra_axes``
    are appended after `model` on the sharded dim (ZeRO-style: optimizer
    moments also shard across the data axes)."""
    name = path_names[-1] if path_names else ""
    rule = _PARAM_RULES.get(name)
    nd = len(leaf.shape)
    if rule:
        for t_nd in sorted(rule, reverse=True):
            if nd >= t_nd:
                spec = rule[t_nd]
                lead = (None,) * (nd - t_nd)
                tail = tuple(
                    _axes_fit(leaf.shape[nd - t_nd + i],
                              (s,) + tuple(extra_axes) if isinstance(s, str)
                              else s, mesh) if s else None
                    for i, s in enumerate(spec))
                return lead + tail
    return (None,) * nd


def to_placements(spec, mesh) -> tuple:
    """DTensor placements of a per-dim spec, one per mesh dim: a shard of
    tensor dim ``i`` on each mesh axis that ``spec[i]`` names, split in the
    spec's order (the module note), ``Replicate()`` on the others."""
    sizes = mesh_sizes(mesh)
    order = list(sizes)
    out = []
    for axis in order:
        dims = [i for i, s in enumerate(spec) if s and axis in s]
        if not dims:
            out.append(Replicate())
            continue
        axes = spec[dims[0]]
        split = 1
        for a in axes[:axes.index(axis)]:
            if order.index(a) > order.index(axis):
                split *= sizes[a]
        out.append(_StridedShard(dims[0], split_factor=split) if split > 1 else Shard(dims[0]))
    return tuple(out)


def local_shape(shape, spec, mesh) -> tuple:
    """A rank's shard shape under ``spec``: each dim divided by the product
    of its mesh axes (``_axes_fit`` only names axes whose product divides
    the dim, so every rank's shard has this shape)."""
    sizes = mesh_sizes(mesh)
    out = []
    for dim, s in zip(shape, spec):
        for a in s or ():
            dim //= sizes[a]
        out.append(dim)
    return tuple(out)


def param_shardings(params, mesh, extra_axes=()):
    """The parameter tree (meta or real) distributed over ``mesh`` by the
    rules: a tree of DTensors. Every rank holds the same tree (drawn from
    one seed), so each keeps its own shard of it and nothing is sent."""
    return tree_map_with_names(
        lambda names, leaf: distribute_tensor(
            leaf, mesh, to_placements(_leaf_spec(names, leaf, mesh, extra_axes), mesh),
            src_data_rank=None),
        params)


def _zeros(shape, dtype, device, mesh, spec):
    """A float DTensor of zeros laid out by ``spec``: each rank allocates
    only its shard."""
    local = torch.zeros(local_shape(shape, spec, mesh), dtype=dtype, device=device)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, mesh, to_placements(spec, mesh), run_check=False,
                              shape=torch.Size(shape), stride=stride)


def zero1_adamw_init(params, mesh, extra_axes=ZERO_AXES) -> AdamWState:
    """``adamw_init`` of a distributed parameter tree with ZeRO-1 moments:
    float32 zeros sharded like each parameter plus across ``extra_axes``
    (fp32 moments replicated over the data ranks do not fit), on the
    parameters' device."""
    def zeros(names, p):
        spec = _leaf_spec(names, p, mesh, extra_axes)
        return _zeros(p.shape, torch.float32, p.to_local().device, mesh, spec)
    return AdamWState(step=0, m=tree_map_with_names(zeros, params),
                      v=tree_map_with_names(zeros, params))


# --------------------------------------------------------------- hook
_LOGICAL = {
    "batch": ("pod", "data"),
    "heads": ("model",),
    "kv_heads": ("model",),
    "experts": ("model",),
    "vocab": ("model",),
}


def logical_spec(shape, logical_axes, mesh) -> tuple:
    """The per-dim spec the hook gives a tensor of ``shape`` annotated with
    ``logical_axes``."""
    spec = []
    for dim, name in zip(shape, logical_axes):
        if name == "seq_fallback":
            # shard this (seq) dim on `model` ONLY when the tensor's head
            # dim (the next axis named heads/kv_heads) cannot be sharded:
            # sequence-parallel attention fallback.
            head_i = next((j for j, n in enumerate(logical_axes)
                           if n in ("heads", "kv_heads")), None)
            head_ok = (head_i is not None and
                       _axes_fit(shape[head_i], ("model",), mesh))
            spec.append(None if head_ok else _axes_fit(dim, ("model",), mesh))
            continue
        if name is None or name not in _LOGICAL or dim == 1:
            # a dim of one element fits only mesh axes of one, where a
            # shard is the whole dim; DTensor's views refuse to fold it
            spec.append(None)
            continue
        spec.append(_axes_fit(dim, _LOGICAL[name], mesh))
    return tuple(spec)


class _Constrain(torch.autograd.Function):
    """A DTensor on ``placements``, and its gradient too: as JAX's
    ``with_sharding_constraint``, whose transpose constrains the cotangent
    to the same sharding. (DTensor's own redistribute sends the gradient
    back to the input's layout, and only when the forward moved anything.)"""

    @staticmethod
    def forward(ctx, x, mesh, placements):
        ctx.mesh, ctx.placements = mesh, placements
        if tuple(x.placements) == placements:
            return x.view_as(x)
        return x.redistribute(mesh, placements)

    @staticmethod
    def backward(ctx, g):
        if isinstance(g, DTensor) and tuple(g.placements) != ctx.placements:
            g = g.redistribute(ctx.mesh, ctx.placements)
        return g, None, None


def install_hook(mesh) -> None:
    """``constrain`` redistributes a DTensor, and its gradient, to the
    placements of its logical axes on ``mesh`` (JAX's
    ``with_sharding_constraint``); a plain tensor passes as it is."""
    def hook(x, logical_axes):
        if not isinstance(x, DTensor):
            return x
        placements = to_placements(logical_spec(x.shape, logical_axes, mesh), mesh)
        return _Constrain.apply(x, mesh, placements)
    hooks.set_hook(hook)


@contextlib.contextmanager
def on_mesh(mesh):
    """Within it the model runs on ``mesh``: ``install_hook(mesh)``, and
    plain tensors the model makes itself (positions, RoPE tables, masks,
    constants) join DTensor ops as replicated (``implicit_replication``).
    The hook is cleared on the way out."""
    install_hook(mesh)
    try:
        with implicit_replication():
            yield
    finally:
        hooks.clear_hook()


def batch_spec(batch: int, mesh) -> Optional[Tuple[str, ...]]:
    return _axes_fit(batch, ("pod", "data"), mesh)


# --------------------------------------------------------------- inputs
def input_specs(cfg: ModelConfig, shape: InputShape, mesh):
    """``meta`` stand-ins and their placements for one workload shape.

    Returns (args: dict of meta tensors, placements: dict of the same keys)
    for the step function of that shape kind (train/prefill: token batch;
    decode: token + cache + positions); the cache's placements are a tree
    like the cache."""
    model = Model(cfg)
    b, s = shape.global_batch, shape.seq_len
    baxes = batch_spec(b, mesh)
    meta = torch.device("meta")
    tok = torch.empty((b, s), dtype=torch.int32, device=meta)
    tok_pl = to_placements((baxes, None), mesh)

    if shape.kind in ("train", "prefill"):
        args = {"tokens": tok}
        placements = {"tokens": tok_pl}
        if shape.kind == "train":
            args["labels"] = torch.empty_like(tok)
            placements["labels"] = tok_pl
        if cfg.multimodal:
            args["mm_embeds"] = torch.empty((b, 256, cfg.mm_embed_dim),
                                            dtype=torch.float32, device=meta)
            placements["mm_embeds"] = to_placements((baxes, None, None), mesh)
        return args, placements

    # decode: one new token against a cache of seq_len positions
    cache_specs = model.make_cache(b, s, as_specs=True)
    cache_pl = tree_map_with_names(
        lambda names, t: to_placements(_cache_spec(names, t, mesh), mesh), cache_specs)
    vec_pl = to_placements((baxes,), mesh)
    args = {
        "tokens": torch.empty((b,), dtype=torch.int32, device=meta),
        "cache": cache_specs,
        "pos": torch.empty((b,), dtype=torch.int32, device=meta),
    }
    return args, {"tokens": vec_pl, "cache": cache_pl, "pos": vec_pl}


def distribute(tree, placements, mesh):
    """A tree of tensors distributed over ``mesh`` by a matching tree of
    placements (``input_specs``'s); as ``param_shardings``, each rank
    keeps its shard of the tree it holds."""
    if isinstance(tree, dict):
        return {k: distribute(v, placements[k], mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(distribute(v, p, mesh) for v, p in zip(tree, placements))
    return distribute_tensor(tree, mesh, placements, src_data_rank=None)


def cache_shardings(model: Model, cache_specs, mesh):
    """Per-dim specs of the decode cache (``Model.make_cache(...,
    as_specs=True)``), a tree like it: attn k/v (B,S,Hkv,hd): batch x
    data, heads x model (if divisible, else the cache's seq dim);
    ssm/rglru states: batch x data, inner dims x model (if divisible)."""
    return tree_map_with_names(lambda names, t: _cache_spec(names, t, mesh), cache_specs)


def _cache_spec(names, t, mesh) -> tuple:
    nd = len(t.shape)
    shape = t.shape
    out = [None] * nd
    if names and names[-1] in ("k", "v"):
        # (..., B, S, Hkv, hd): heads on model when divisible, else
        # shard the cache SEQ dim (sequence-parallel decode attention)
        out[nd - 4] = _axes_fit(shape[nd - 4], ("pod", "data"), mesh)
        heads_fit = _axes_fit(shape[nd - 2], ("model",), mesh)
        if heads_fit:
            out[nd - 2] = heads_fit
        else:
            out[nd - 3] = _axes_fit(shape[nd - 3], ("model",), mesh)
    elif names and names[-1] == "conv":
        out[nd - 3] = _axes_fit(shape[nd - 3], ("pod", "data"), mesh)
        out[nd - 1] = _axes_fit(shape[nd - 1], ("model",), mesh)
    elif names and names[-1] == "ssd":
        # (..., B, H, P, N)
        out[nd - 4] = _axes_fit(shape[nd - 4], ("pod", "data"), mesh)
        out[nd - 3] = _axes_fit(shape[nd - 3], ("model",), mesh)
    elif names and names[-1] == "h":
        out[nd - 2] = _axes_fit(shape[nd - 2], ("pod", "data"), mesh)
        out[nd - 1] = _axes_fit(shape[nd - 1], ("model",), mesh)
    return tuple(out)
