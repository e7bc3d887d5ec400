"""Decoder-stack layout: segments and per-family block parameters.

Layers are grouped into *segments* exactly as in ``repro/models/transformer.py``:
a homogeneous (or pattern-repeating) run whose parameters are stacked on a
leading layer axis, plus an optional unrolled remainder. The paged runner
walks the stack itself (``repro_torch/models/paged.py``); the context/decode
stack walks of the dense-cache path are not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn_mod
from repro_torch.models.common import swiglu_init


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
    if kind in ("moe", "ssm", "rglru"):
        raise NotImplementedError(f"{kind!r} blocks are not ported yet")
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
