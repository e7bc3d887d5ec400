"""Decoder-stack layout: segments, per-family block parameters, and the
decode walk over the stack.

Layers are grouped into *segments* exactly as in ``repro/models/transformer.py``:
a homogeneous (or pattern-repeating) run whose parameters are stacked on a
leading layer axis, plus an optional unrolled remainder. The paged runner
walks the attention stack itself (``repro_torch/models/paged.py``), and the
state runner walks the SSM stack in prefill
(``repro_torch/models/state_cache.py``). ``stack_decode`` is ported for
"ssm" blocks; the dense-cache attention blocks (``attn_decode``), "moe",
"rglru" and ``stack_context`` are not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import rms_norm, swiglu_init
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
    if kind == "attn":
        ones = dict(dtype=dtype, device=gen.device)
        return {"ln1": torch.ones(lead + (d,), **ones),
                "attn": attn_mod.attn_init(gen, cfg, dtype, lead),
                "ln2": torch.ones(lead + (d,), **ones),
                "mlp": swiglu_init(gen, d, cfg.d_ff, dtype, lead)}
    if kind == "ssm":
        return {"ln": torch.ones(lead + (d,), dtype=dtype, device=gen.device),
                "ssm": ssm_mod.ssm_init(gen, cfg, dtype, lead)}
    if kind in ("moe", "rglru"):
        raise NotImplementedError(f"{kind!r} blocks are not ported yet")
    raise ValueError(kind)


def block_decode(kind, p, cfg, x, rope, cache, pos):
    """One block on one token per row: x (B,1,d) -> (x, new cache)."""
    if kind == "ssm":
        h, cache = ssm_mod.ssm_decode(p["ssm"], cfg,
                                      rms_norm(x, p["ln"], cfg.norm_eps), cache)
        return x + h, cache
    if kind in ("attn", "moe", "rglru"):
        raise NotImplementedError(
            f"dense-cache decode of {kind!r} blocks is not ported yet")
    raise ValueError(kind)


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


def stack_decode(params_segs, cfg, x, rope, caches, pos):
    """Apply all layers to one token per row. Scan segments walk their
    stacked layers in a Python loop (JAX's ``lax.scan``) and return their
    caches stacked anew: nothing is written in place."""
    new_caches = []
    for (stype, unit, n), seg_p, seg_c in zip(segments(cfg), params_segs, caches):
        if stype == "scan":
            outs = [[] for _ in unit]
            for i in range(n):
                for j, (kind, p_k, c_k) in enumerate(zip(unit, seg_p, seg_c)):
                    x, c = block_decode(kind, tree_map(lambda a: a[i], p_k), cfg,
                                        x, rope, tree_map(lambda a: a[i], c_k), pos)
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
