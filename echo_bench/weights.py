"""Seeded weights in the port's parameter layout, made by the benchmark.

All leaves are views of one flat buffer in the served dtype, filled in
place by ``normal_`` in slices of 2^30 elements (a few large calls) on the
run's device from a ``torch.Generator`` seeded with the run seed, then scaled a leaf at a time: projections by
1/sqrt(fan-in), the embedding (and an untied unembedding) by 0.02, the
norm scales drawn around 1 (1 + 0.1 n), so that a norm that drops its
scale is seen. The same tensors go to the port (which keeps them as they
are: ``TorchPagedRunner`` moves each leaf with ``.to(device)``) and to the
plain reference, which reads them and computes in float32.
"""
from __future__ import annotations

import math

import torch

SLICE = 1 << 30
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def layout(m: dict):
    """(path, shape, kind) of every leaf; kind is "norm", "embed" or the
    fan-in of a projection. Paths index the port's tree: ``layers`` is one
    stacked segment of one "attn" unit."""
    n, d, hq, hkv, hd, ff, v = (m["num_layers"], m["d_model"], m["num_heads"],
                                m["num_kv_heads"], m["head_dim"], m["d_ff"],
                                m["vocab_size"])
    leaves = [(("embed",), (v, d), "embed"), (("final_ln",), (d,), "norm"),
              (("ln1",), (n, d), "norm"), (("ln2",), (n, d), "norm"),
              (("attn", "wq"), (n, d, hq, hd), d), (("attn", "wk"), (n, d, hkv, hd), d),
              (("attn", "wv"), (n, d, hkv, hd), d), (("attn", "wo"), (n, hq, hd, d), hq * hd),
              (("mlp", "w1"), (n, d, ff), d), (("mlp", "w3"), (n, d, ff), d),
              (("mlp", "w2"), (n, ff, d), ff)]
    if m["qk_norm"]:
        leaves += [(("attn", "q_norm"), (n, hd), "norm"),
                   (("attn", "k_norm"), (n, hd), "norm")]
    if not m["tie_embeddings"]:
        leaves.append((("unembed",), (d, v), "embed"))
    return leaves


def make_params(m: dict, seed: int, device) -> dict:
    """The port's tree: {"embed", "final_ln", "layers": [({"ln1", "attn":
    {...}, "ln2", "mlp": {...}},)], ["unembed"]}."""
    dtype = DTYPES[m["dtype"]]
    leaves = layout(m)
    total = sum(math.prod(shape) for _, shape, _ in leaves)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.empty(total, dtype=dtype, device=device)
    for a in range(0, total, SLICE):
        flat[a: a + SLICE].normal_(generator=gen)
    layer, top, off = {"attn": {}, "mlp": {}}, {}, 0
    for path, shape, kind in leaves:
        t = flat[off: off + math.prod(shape)].view(shape)
        off += t.numel()
        if kind == "norm":
            t.mul_(0.1).add_(1.0)
        elif kind == "embed":
            t.mul_(0.02)
        else:
            t.mul_(1.0 / math.sqrt(kind))
        if path[0] in ("embed", "final_ln", "unembed"):
            top[path[0]] = t
        elif len(path) == 1:
            layer[path[0]] = t
        else:
            layer[path[0]][path[1]] = t
    top["layers"] = [(layer,)]
    return top

