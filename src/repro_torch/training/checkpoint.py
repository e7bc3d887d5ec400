"""Parameter tree <-> .npz checkpointing, the layout of
``repro/training/checkpoint.py``: ``__treedef__`` is the JSON ``{n, step}``
as uint8, then ``leaf_i`` for each leaf in JAX's leaf order.

A bfloat16 leaf is stored as JAX's file stores it: its raw 2-byte values
under the header type ``<V2`` (numpy has no bfloat16), so the members are
byte for byte what the JAX package writes. ``restore`` reads float32 and
such 2-byte leaves (as bfloat16 bits), so a float32 file written by either
package restores in the other, and a bfloat16 file restores here.
"""
from __future__ import annotations

import json
import os
import zipfile
from typing import Any, Tuple

import numpy as np
import torch

from repro_torch.params import tree_leaves, tree_unflatten


def _write_member(zf, name, arr):
    """One ``.npy`` member, as ``np.savez`` writes it."""
    with zf.open(name + ".npy", "w", force_zip64=True) as f:
        if arr.dtype == torch.bfloat16:
            t = arr.detach().cpu().contiguous()
            np.lib.format.write_array_header_1_0(
                f, {"descr": "<V2", "fortran_order": False, "shape": tuple(t.shape)})
            f.write(t.view(torch.int16).numpy().tobytes())
        else:
            a = arr if isinstance(arr, np.ndarray) else arr.detach().cpu().numpy()
            np.lib.format.write_array(f, np.ascontiguousarray(a), allow_pickle=False)


def save(path: str, tree: Any, step: int = 0) -> None:
    leaves = tree_leaves(tree)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    meta = np.frombuffer(json.dumps({"n": len(leaves), "step": step}).encode(),
                         dtype=np.uint8)
    with zipfile.ZipFile(path if path.endswith(".npz") else path + ".npz", "w",
                         compression=zipfile.ZIP_STORED, allowZip64=True) as zf:
        _write_member(zf, "__treedef__", meta)
        for i, x in enumerate(leaves):
            _write_member(zf, f"leaf_{i}", x)


def _leaf(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:      # bfloat16 bits
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a).copy())
    return t.to(device=like.device, dtype=like.dtype)


def restore(path: str, like: Any) -> Tuple[Any, int]:
    """(tree shaped, typed and placed like ``like``, step)."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    with np.load(path) as data:
        meta = json.loads(bytes(data["__treedef__"]).decode())
        leaves_like = tree_leaves(like)
        if meta["n"] != len(leaves_like):
            raise ValueError(f"checkpoint holds {meta['n']} leaves, the model "
                             f"{len(leaves_like)}")
        leaves = [_leaf(data[f"leaf_{i}"], x) for i, x in enumerate(leaves_like)]
    return tree_unflatten(like, leaves), meta["step"]
