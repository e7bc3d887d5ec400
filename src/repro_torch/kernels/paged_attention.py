"""Split-K paged decode attention: the CUDA kernel's wrapper.

The kernel (``csrc/paged_attention_splitk.cu``) replaces the TPU kernel
``repro/kernels/paged_attention.py::paged_attention_splitk``; its source
note says what bounds it on the card (bytes: every live KV row is read
once) and how the design answers that. Its plain version is
``ref_paged_attention``: a CPU tensor goes there, a CUDA tensor goes to
the kernel or the call raises.

The legacy serial-page schedule (``paged_attention`` in the JAX package)
is not ported yet.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import ref_paged_attention

HEAD_DIMS = (16, 32, 64, 128)
PAGE_SIZES = (4, 8, 16)
MAX_GROUP = 8          # query heads per kv head the kernel holds on chip

_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _num_sms(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def default_num_splits(b: int, hkv: int, nblk: int, num_sms: int) -> int:
    """Enough splits for about two waves of CTAs on the card: the
    (sequence, kv head) pairs alone leave SMs idle at small batch. The
    kernel divides each row's live pages among them, so a split never
    holds more than its share of a short context."""
    want = -(-2 * num_sms // max(b * hkv, 1))
    return max(1, min(nblk, want))


def _check(q, k_pages, v_pages, block_tables, ctx_lens):
    if q.dim() != 3 or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError("expected q (B,Hq,hd) and k/v pages (P,bs,Hkv,hd)")
    b, hq, hd = q.shape
    _, bs, hkv, hd_k = k_pages.shape
    if hd_k != hd or hq % hkv:
        raise ValueError(f"head shapes disagree: q {tuple(q.shape)}, "
                         f"pages {tuple(k_pages.shape)}")
    if hd not in HEAD_DIMS or bs not in PAGE_SIZES or hq // hkv > MAX_GROUP:
        raise ValueError(f"kernel takes hd in {HEAD_DIMS}, bs in {PAGE_SIZES} "
                         f"and at most {MAX_GROUP} query heads per kv head; "
                         f"got hd={hd}, bs={bs}, G={hq // hkv}")
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise ValueError("q and the pages must share float32 or bfloat16")
    if block_tables.dtype != torch.int32 or ctx_lens.dtype != torch.int32 or \
            block_tables.dim() != 2 or block_tables.shape[0] != b or \
            tuple(ctx_lens.shape) != (b,):
        raise ValueError("block_tables (B,nblk) and ctx_lens (B,) must be int32")
    for t in (q, k_pages, v_pages, block_tables, ctx_lens):
        if t.device != q.device:
            raise ValueError("all operands must be on one device")
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")
    for t in (q, k_pages, v_pages):
        if t.data_ptr() % 16:
            raise ValueError("q and the pages must be 16-byte aligned")


def paged_attention_splitk(q, k_pages, v_pages, block_tables, ctx_lens, *,
                           num_splits=None):
    """q (B,Hq,hd); k/v_pages (P,bs,Hkv,hd); block_tables (B,nblk) int32;
    ctx_lens (B,) int32 -> (B,Hq,hd) in q's dtype.

    CPU tensors run the plain version. CUDA tensors launch the kernel:
    each row's live pages in ``num_splits`` equal shares (by default
    enough for two waves of CTAs), an unnormalised float32 partial per
    share, then a log-sum-exp merge. A row with ctx = 0 comes out as
    zeros."""
    if q.device.type == "cpu":
        return ref_paged_attention(q, k_pages, v_pages, block_tables, ctx_lens)
    if q.device.type != "cuda":
        raise ValueError(f"no paged attention for device {q.device}")
    fn = build.kernel_fn("paged_attention_splitk", "paged_attention_splitk",
                         _ARGTYPES)
    _check(q, k_pages, v_pages, block_tables, ctx_lens)
    b, hq, hd = q.shape
    _, bs, hkv, _ = k_pages.shape
    nblk = block_tables.shape[1]
    g = hq // hkv
    nsplit = num_splits or default_num_splits(
        b, hkv, nblk, _num_sms(q.device.index or 0))
    nsplit = max(1, min(nsplit, nblk))
    f32 = dict(dtype=torch.float32, device=q.device)
    o_part = torch.empty((b, hkv, nsplit, g, hd), **f32)
    m_part = torch.empty((b, hkv, nsplit, g), **f32)
    l_part = torch.empty((b, hkv, nsplit, g), **f32)
    out = torch.empty_like(q)
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             block_tables.data_ptr(), ctx_lens.data_ptr(), o_part.data_ptr(),
             m_part.data_ptr(), l_part.data_ptr(), out.data_ptr(),
             b, hq, hkv, hd, bs, nblk, nsplit,
             int(q.dtype == torch.bfloat16),
             torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "paged_attention_splitk")
    paged_attention_splitk.launches += 1
    return out


paged_attention_splitk.launches = 0
