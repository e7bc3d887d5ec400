"""Decoder-stack layout: segments, per-family block parameters, and the
context and decode walks over the stack.

Layers are grouped into *segments* exactly as in ``repro/models/transformer.py``:
a homogeneous (or pattern-repeating) run whose parameters are stacked on a
leading layer axis, plus an optional unrolled remainder (e.g.
recurrentgemma's 38 = 12 x (rglru, rglru, attn) + 2 x rglru). A scan
segment may hold no layer at all (recurrentgemma reduced to 2 layers is an
empty scan segment plus the unrolled pair). The paged runner walks the
attention stack itself (``repro_torch/models/paged.py``), and the state
runner walks the SSM stack in prefill (``repro_torch/models/state_cache.py``).
``stack_context`` and ``stack_decode`` serve "attn", "moe", "ssm" and
"rglru" blocks; a "moe" block is the attention block with the routed
experts (``repro_torch/models/moe.py``) in place of the SwiGLU MLP.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import rms_norm, swiglu, swiglu_init
from repro_torch.models.hooks import constrain
from repro_torch.params import tree_map


# ----------------------------------------------------------------- segments
def segments(cfg):
    """Returns list of ('scan', unit, n) / ('unroll', kinds) entries."""
    kinds = cfg.attn_layers
    if cfg.block_pattern:
        unit = tuple(cfg.block_pattern)
        n = len(kinds) // len(unit)
        segs = [("scan", unit, n)]
        rem = kinds[n * len(unit):]
        if rem:
            segs.append(("unroll", tuple(rem), 1))
        return segs
    return [("scan", (kinds[0],), len(kinds))]


# ----------------------------------------------------------------- blocks
def block_init(kind, gen: torch.Generator, cfg, dtype, lead=()):
    """One block's parameters; ``lead`` prepends the stacked-layer axis."""
    lead = tuple(lead)
    d = cfg.d_model
    if kind in ("attn", "moe"):
        ones = dict(dtype=dtype, device=gen.device)
        p = {"ln1": torch.ones(lead + (d,), **ones),
             "attn": attn_mod.attn_init(gen, cfg, dtype, lead),
             "ln2": torch.ones(lead + (d,), **ones)}
        if kind == "attn":
            p["mlp"] = swiglu_init(gen, d, cfg.d_ff, dtype, lead)
        else:
            p["moe"] = moe_mod.moe_init(gen, cfg, dtype, lead)
        return p
    if kind == "ssm":
        return {"ln": torch.ones(lead + (d,), dtype=dtype, device=gen.device),
                "ssm": ssm_mod.ssm_init(gen, cfg, dtype, lead)}
    if kind == "rglru":
        ones = dict(dtype=dtype, device=gen.device)
        return {"ln1": torch.ones(lead + (d,), **ones),
                "rglru": rglru_mod.rglru_init(gen, cfg, dtype, lead),
                "ln2": torch.ones(lead + (d,), **ones),
                "mlp": swiglu_init(gen, d, cfg.d_ff, dtype, lead)}
    raise ValueError(kind)


def ffn(kind, p, cfg, x):
    """The feed-forward half of an "attn" or "moe" block on its normed
    input: the SwiGLU MLP or the routed experts."""
    if kind == "attn":
        return swiglu(p["mlp"], x)
    return moe_mod.moe_apply(p["moe"], cfg, x)


def _stream(h):
    """A sublayer's output as it joins the residual stream: sharded on the
    batch only. Under a mesh this sums a row-parallel product's partial
    results (Megatron's all-reduce); left to itself DTensor would
    reduce-scatter them onto the sequence dim, and flattening a (B, S)
    sharded on both for the next product makes strided shards. Without a
    hook, ``h`` as it is."""
    return constrain(h, ("batch", None, None))


def _attn_window(cfg):
    return cfg.window if cfg.block_pattern else 0


def block_context(kind, p, cfg, x, rope, *, seq_lens=None, return_cache=False):
    """One block over a whole sequence: x (B,S,d) -> (x, cache or None)."""
    cos, sin = rope
    if kind in ("attn", "moe"):
        h, cache = attn_mod.attn_context(
            p["attn"], cfg, rms_norm(x, p["ln1"], cfg.norm_eps), cos, sin,
            window=_attn_window(cfg), seq_lens=seq_lens, return_cache=return_cache)
        x = x + _stream(h)
        return x + _stream(ffn(kind, p, cfg, rms_norm(x, p["ln2"], cfg.norm_eps))), cache
    if kind == "ssm":
        h, cache = ssm_mod.ssm_context(
            p["ssm"], cfg, rms_norm(x, p["ln"], cfg.norm_eps),
            return_cache=return_cache)
        return x + _stream(h), cache
    if kind == "rglru":
        h, cache = rglru_mod.rglru_context(
            p["rglru"], cfg, rms_norm(x, p["ln1"], cfg.norm_eps),
            return_cache=return_cache)
        x = x + _stream(h)
        return x + _stream(swiglu(p["mlp"], rms_norm(x, p["ln2"], cfg.norm_eps))), cache
    raise ValueError(kind)


def block_decode(kind, p, cfg, x, rope, cache, pos):
    """One block on one token per row: x (B,1,d) -> (x, new cache)."""
    cos, sin = rope
    if kind in ("attn", "moe"):
        h, cache = attn_mod.attn_decode(
            p["attn"], cfg, rms_norm(x, p["ln1"], cfg.norm_eps), cos, sin, cache, pos)
        x = x + _stream(h)
        return x + _stream(ffn(kind, p, cfg, rms_norm(x, p["ln2"], cfg.norm_eps))), cache
    if kind == "ssm":
        h, cache = ssm_mod.ssm_decode(p["ssm"], cfg,
                                      rms_norm(x, p["ln"], cfg.norm_eps), cache)
        return x + _stream(h), cache
    if kind == "rglru":
        h, cache = rglru_mod.rglru_decode(
            p["rglru"], cfg, rms_norm(x, p["ln1"], cfg.norm_eps), cache)
        x = x + _stream(h)
        return x + _stream(swiglu(p["mlp"], rms_norm(x, p["ln2"], cfg.norm_eps))), cache
    raise ValueError(kind)


def _empty_context_cache(kind, cfg, x):
    """The cache of an empty scan segment (n = 0): JAX's ``lax.scan`` over
    no layers still returns every cache leaf, with a layer axis of length
    0. The shapes are those ``block_context`` returns."""
    b, s, _ = x.shape

    def empty(shape, dtype=x.dtype):
        return x.new_zeros((0,) + shape, dtype=dtype)
    if kind == "attn":
        shp = (b, s, cfg.num_kv_heads, cfg.head_dim)
        return {"k": empty(shp), "v": empty(shp)}
    if kind == "rglru":
        w = rglru_mod.rglru_width(cfg)
        return {"conv": empty((b, cfg.ssm_conv, w)),
                "h": empty((b, w), torch.float32)}
    raise ValueError(f"no empty scan segment of {kind!r} blocks")


# ----------------------------------------------------------------- stacks
def stack_init(gen: torch.Generator, cfg, dtype):
    """Segment list mirroring ``repro``'s: a scan segment is a tuple (one
    entry per unit kind) of parameter dicts stacked on a leading axis of n
    layers; an unrolled segment holds one unstacked dict per kind."""
    segs = []
    for stype, unit, n in segments(cfg):
        if stype == "scan":
            segs.append(tuple(block_init(kind, gen, cfg, dtype, (n,))
                              for kind in unit))
        else:
            segs.append(tuple(block_init(kind, gen, cfg, dtype)
                              for kind in unit))
    return segs


def stack_layers(trees):
    """Stack a list of equally shaped dicts of tensors on a new leading axis."""
    return {k: torch.stack([t[k] for t in trees]) for k in trees[0]}


def _layers_whole(p):
    """A stacked leaf whose layer axis is sharded (a rule for a
    three-dimensional weight met a stack of two-dimensional ones whose
    depth the mesh axis divides, as in the reference) gathered on that
    axis, so that a layer can be taken out; anything else as it is."""
    if isinstance(p, DTensor) and Shard(0) in p.placements:
        return p.redistribute(p.device_mesh, [Replicate() if q == Shard(0) else q
                                              for q in p.placements])
    return p


def _layer(p, i):
    return tree_map(lambda a: _layers_whole(a)[i], p)


def _unbind_layers(p, n):
    """The n layers of a stacked parameter dict, each leaf split once by
    ``torch.unbind``: its backward stacks the n layers' gradients once,
    where ``a[i]`` for each layer would add a zero tensor the size of the
    whole stack per layer."""
    if isinstance(p, dict):
        parts = {k: _unbind_layers(v, n) for k, v in p.items()}
        return [{k: parts[k][i] for k in p} for i in range(n)]
    return _layers_whole(p).unbind(0)


def _unit(unit, layer_ps, cfg, x, rope):
    for kind, p_k in zip(unit, layer_ps):
        x, _ = block_context(kind, p_k, cfg, x, rope)
    return x


def _stack_train(params_segs, cfg, x, rope):
    """The training walk: each unit of a scan segment under
    ``torch.utils.checkpoint`` (non-reentrant), as JAX checkpoints its scan
    body, so the backward recomputes the unit from its input; the unrolled
    remainder as it is, as in JAX. The stacked leaves are split once a
    segment, outside the checkpointed units."""
    for (stype, unit, n), seg_p in zip(segments(cfg), params_segs):
        if stype == "unroll":
            x = _unit(unit, seg_p, cfg, x, rope)
            continue
        if n == 0:
            continue
        layers = [_unbind_layers(p_k, n) for p_k in seg_p]
        for i in range(n):
            x = checkpoint(_unit, unit, [lay[i] for lay in layers], cfg, x, rope,
                           use_reentrant=False)
    return x


def stack_context(params_segs, cfg, x, rope, *, train=False, seq_lens=None,
                  return_cache=False):
    """Apply all layers in context mode. Returns (x, caches or None); scan
    segments stack their layers' caches on a leading axis. ``train=True``
    is ``Model.forward_train``'s walk (``_stack_train``): no padding mask
    and no caches."""
    if train:
        if seq_lens is not None or return_cache:
            raise ValueError("the training walk takes no seq_lens and returns no cache")
        return _stack_train(params_segs, cfg, x, rope), None
    caches = []
    for (stype, unit, n), seg_p in zip(segments(cfg), params_segs):
        outs = [[] for _ in unit]
        for i in range(n if stype == "scan" else 1):
            for j, (kind, p_k) in enumerate(zip(unit, seg_p)):
                if stype == "scan":
                    p_k = _layer(p_k, i)
                x, c = block_context(kind, p_k, cfg, x, rope, seq_lens=seq_lens,
                                     return_cache=return_cache)
                outs[j].append(c)
        if not return_cache:
            seg_cache = None
        elif stype == "unroll":
            seg_cache = tuple(o[0] for o in outs)
        elif n == 0:
            seg_cache = tuple(_empty_context_cache(kind, cfg, x) for kind in unit)
        else:
            seg_cache = tuple(stack_layers(o) for o in outs)
        caches.append(seg_cache)
    return x, (caches if return_cache else None)


def stack_decode(params_segs, cfg, x, rope, caches, pos):
    """Apply all layers to one token per row. Scan segments walk their
    stacked layers in a Python loop (JAX's ``lax.scan``) and return their
    caches stacked anew: nothing is written in place. An empty scan
    segment passes its (empty) caches through."""
    new_caches = []
    for (stype, unit, n), seg_p, seg_c in zip(segments(cfg), params_segs, caches):
        if stype == "scan" and n == 0:
            seg_new = seg_c
        elif stype == "scan":
            outs = [[] for _ in unit]
            for i in range(n):
                for j, (kind, p_k, c_k) in enumerate(zip(unit, seg_p, seg_c)):
                    x, c = block_decode(kind, _layer(p_k, i), cfg, x, rope,
                                        _layer(c_k, i), pos)
                    outs[j].append(c)
            seg_new = tuple(stack_layers(o) for o in outs)
        else:
            outs = []
            for kind, p_k, c_k in zip(unit, seg_p, seg_c):
                x, c = block_decode(kind, p_k, cfg, x, rope, c_k, pos)
                outs.append(c)
            seg_new = tuple(outs)
        new_caches.append(seg_new)
    return x, new_caches
