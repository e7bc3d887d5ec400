"""Parameter pytrees: the bridge from the JAX package's params and the
tree helpers the runner uses.

A parameter tree is the JAX layout verbatim: dicts of tensors, with
``"layers"`` a list of segments, each a tuple of per-kind dicts whose
tensors are stacked on a leading layer axis for scan segments.
"""
from __future__ import annotations

import numpy as np
import torch


def tree_map(fn, tree):
    """Apply ``fn`` to every leaf of a dict / list / tuple tree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree):
    """Leaves in JAX's order (dict keys sorted), so that they line up with
    ``jax.tree.leaves`` of the same tree."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(like, leaves):
    """A tree shaped like ``like`` holding ``leaves`` (in ``tree_leaves``
    order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            vals = {k: build(t[k]) for k in sorted(t)}
            return {k: vals[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)
    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def _leaf_from_numpy(a, device):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # numpy has no bfloat16: carry the raw bits across and reinterpret
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)


def from_jax(params_np, device):
    """The port's params from the JAX param tree with numpy leaves
    (``jax.tree.map(np.asarray, params)``). Keeps the segment structure and
    every dtype (bfloat16 leaves included)."""
    return tree_map(lambda a: _leaf_from_numpy(a, device), params_np)
