"""Parameter tree <-> .npz checkpointing, the layout of
``repro/training/checkpoint.py``: ``__treedef__`` is the JSON ``{n, step}``
as uint8, then ``leaf_i`` for each leaf in JAX's leaf order.

A bfloat16 leaf is stored as JAX's file stores it: its raw 2-byte values
under the header type ``<V2`` (numpy has no bfloat16), so the members are
byte for byte what the JAX package writes. ``restore`` reads float32 and
such 2-byte leaves (as bfloat16 bits), so a float32 file written by either
package restores in the other, and a bfloat16 file restores here.

A mesh's training state (DTensor leaves: the parameters of
``repro_torch.launch.sharding.param_shardings``, ZeRO-1 moments) saves as
the reference saves a sharded ``jax.Array``, as its global array: every
rank gathers each leaf in turn (``full_tensor``), rank 0 writes it, and
the ranks meet at a barrier once the file is closed. ``restore`` gives
such a leaf back in ``like``'s mesh and placements: each rank cuts its own
blocks of the global array (``distribute_tensor`` without a source rank,
strided blocks included) and sends nothing.
"""
from __future__ import annotations

import json
import os
import zipfile
from typing import Any, Tuple

import contextlib

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

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
    """Writes ``tree`` with ``step``. With DTensor leaves every rank of
    their mesh must call it: each leaf is gathered whole, rank 0 writes."""
    leaves = tree_leaves(tree)
    sharded = any(isinstance(x, DTensor) for x in leaves)
    writer = not sharded or dist.get_rank() == 0
    path = path if path.endswith(".npz") else path + ".npz"
    if writer:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    meta = np.frombuffer(json.dumps({"n": len(leaves), "step": step}).encode(),
                         dtype=np.uint8)
    with (zipfile.ZipFile(path, "w", compression=zipfile.ZIP_STORED, allowZip64=True)
          if writer else contextlib.nullcontext()) as zf:
        if writer:
            _write_member(zf, "__treedef__", meta)
        for i, x in enumerate(leaves):
            x = x.full_tensor() if isinstance(x, DTensor) else x
            if writer:
                _write_member(zf, f"leaf_{i}", x)
    if sharded:
        dist.barrier()


def _leaf(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:      # bfloat16 bits
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a).copy())
    if isinstance(like, DTensor):
        # every rank read the same global array: each keeps its own blocks
        return distribute_tensor(t.to(device=like.to_local().device, dtype=like.dtype),
                                 like.device_mesh, like.placements, src_data_rank=None)
    return t.to(device=like.device, dtype=like.dtype)


def restore(path: str, like: Any) -> Tuple[Any, int]:
    """(tree shaped, typed and placed like ``like``, step); a DTensor leaf
    in ``like``'s mesh and placements."""
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
