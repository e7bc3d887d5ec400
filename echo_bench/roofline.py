"""Peaks of one H100 and the work of each call the window drives.

Peaks: NVIDIA's data sheet for the H100 SXM, dense, at its 700 W limit:
989 TFLOP/s in bf16 (67 TFLOP/s in float32 outside the tensor cores) and
3.35 TB/s of HBM. A kernel's bound is the larger of its operations over
the peak rate and its bytes over the bandwidth; bytes count each input
read once and each output written once.

The attention kernels' work counts live rows only (the arithmetic of
``chip_smoke.py``'s kernel lines, restricted to them): a prefill chunk's
live query rows, each against the keys up to its causal frontier, and the
keys and values up to the chunk's last live row; a decode step's live
rows and their context lengths, with their page-table entries. The chunk's
padding rows and the decode batch's padding rows do not count.
"""
from __future__ import annotations

from typing import Sequence

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
ITEMSIZE = {"bfloat16": 2, "float32": 4}


def bound_s(nbytes: float, flops: float, dtype: str) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype])


def prefill_attn_work(m: dict, chunk_len: int, ctx: int):
    """(bytes, flops) of one chunked-prefill launch (one layer): query rows
    ctx .. ctx + chunk_len - 1, each attending keys 0 .. its own row."""
    it, hq, hkv, hd = ITEMSIZE[m["dtype"]], m["num_heads"], m["num_kv_heads"], m["head_dim"]
    keys = ctx + chunk_len
    nbytes = 2 * chunk_len * hq * hd * it + 2 * keys * hkv * hd * it
    pairs = chunk_len * ctx + chunk_len * (chunk_len + 1) // 2
    return nbytes, 4 * hd * hq * pairs


def decode_attn_work(m: dict, ctx: Sequence[int], block_size: int):
    """(bytes, flops) of one decode launch (one layer) over live rows of
    context lengths ``ctx`` (the new token included)."""
    it, hq, hkv, hd = ITEMSIZE[m["dtype"]], m["num_heads"], m["num_kv_heads"], m["head_dim"]
    b, total = len(ctx), sum(ctx)
    pages = sum(-(-c // block_size) for c in ctx)
    nbytes = 2 * b * hq * hd * it + 2 * total * hkv * hd * it + 4 * pages + 4 * b
    return nbytes, 4 * total * hq * hd


def layer_matmul_flops(m: dict) -> int:
    """Matrix-product FLOPs of one token through one layer: the q, k, v and
    output projections and the SwiGLU MLP."""
    d, hq, hkv, hd, ff = (m["d_model"], m["num_heads"], m["num_kv_heads"],
                          m["head_dim"], m["d_ff"])
    return 2 * (d * hq * hd + 2 * d * hkv * hd + hq * hd * d + 3 * d * ff)


def prefill_call_flops(m: dict, chunk_len: int, ctx: int) -> int:
    """Live FLOPs of one ``prefill_chunk`` call: every layer on the live
    rows, attention at their contexts, and the one row of logits."""
    _, att = prefill_attn_work(m, chunk_len, ctx)
    per_layer = chunk_len * layer_matmul_flops(m) + att
    return m["num_layers"] * per_layer + 2 * m["d_model"] * m["vocab_size"]


def decode_call_flops(m: dict, ctx: Sequence[int], block_size: int) -> int:
    """Live FLOPs of one ``decode`` call over its live rows."""
    _, att = decode_attn_work(m, ctx, block_size)
    b = len(ctx)
    per_layer = b * layer_matmul_flops(m) + att
    return m["num_layers"] * per_layer + b * 2 * m["d_model"] * m["vocab_size"]
