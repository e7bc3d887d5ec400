"""Chunked-prefill causal attention: the CUDA kernel's wrapper.

The kernel (``csrc/chunked_prefill.cu``) replaces the TPU kernel
``repro/kernels/chunked_prefill.py::chunked_prefill_attention``; its source
note says what bounds it on the card and how the design answers that. Its
plain version is ``ref_chunked_prefill_attention``: a CPU tensor goes
there, a CUDA tensor goes to the kernel or the call raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import ref_chunked_prefill_attention

HEAD_DIMS = (16, 32, 64, 128)
TILE_ROWS = (32, 64)   # packed (query position, group member) rows a CTA, bf16
DEFAULT_TILE_ROWS = 64  # as fast as 32 on the card (PERF.md), half the K/V reads

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


def _check(q, k, v):
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape:
        raise ValueError("expected q (Sc,Hq,hd) and k/v (T,Hkv,hd)")
    _, hq, hd = q.shape
    _, hkv, hd_k = k.shape
    if hd_k != hd or hq % hkv:
        raise ValueError(f"head shapes disagree: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"kernel takes hd in {HEAD_DIMS}, got {hd}")
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("q, k and v must share float32 or bfloat16")
    for t in (q, k, v):
        if t.device != q.device:
            raise ValueError("all operands must be on one device")
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError("operands must be 16-byte aligned")


def chunked_prefill_attention(q, k, v, ctx_len, *, tile_rows=DEFAULT_TILE_ROWS):
    """q (Sc,Hq,hd); k/v (T,Hkv,hd); ctx_len int -> (Sc,Hq,hd) in q's dtype.

    Rows of k/v beyond ctx_len + Sc are padding (masked by causality). CPU
    tensors run the plain version; CUDA tensors launch the kernel. In bf16
    a CTA takes ``tile_rows`` packed rows: one kv head's G query heads at
    consecutive positions."""
    if q.device.type == "cpu":
        return ref_chunked_prefill_attention(q, k, v, ctx_len)
    if q.device.type != "cuda":
        raise ValueError(f"no chunked prefill attention for device {q.device}")
    fn = build.kernel_fn("chunked_prefill", "chunked_prefill_attention",
                         _ARGTYPES)
    _check(q, k, v)
    if tile_rows not in TILE_ROWS:
        raise ValueError(f"tile_rows must be one of {TILE_ROWS}, got {tile_rows}")
    sc, hq, hd = q.shape
    t, hkv, _ = k.shape
    out = torch.empty_like(q)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             sc, t, hq, hkv, hd, int(ctx_len), int(q.dtype == torch.bfloat16),
             tile_rows, torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "chunked_prefill_attention")
    chunked_prefill_attention.launches += 1
    return out


chunked_prefill_attention.launches = 0
