"""Paged decode attention: the wrappers of the two CUDA kernels.

``paged_attention_splitk`` (``csrc/paged_attention_splitk.cu``) replaces the
TPU kernel ``repro/kernels/paged_attention.py::paged_attention_splitk``;
``paged_attention`` (``csrc/paged_attention.cu``) replaces the legacy
schedule ``repro/kernels/paged_attention.py::paged_attention``.
Their source notes say what bounds them on the card (bytes: every live KV
row is read once) and how each design answers that. Both share one
contract and one plain version, ``ref_paged_attention``: a CPU tensor goes
there, a CUDA tensor goes to the kernel or the call raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import ref_paged_attention

HEAD_DIMS = (16, 32, 64, 128)
PAGE_SIZES = (4, 8, 16)
# a CTA holds one slice of at most this many of a kv head's G query heads
# (the 8 columns of mma.m16n8k16); any G runs as ceil(G / 8) slices
SLICE_ROWS = 8

# split-K's launch: the splits of one (sequence, kv head) form one thread-
# block cluster, at most the portable cluster size; a split's four warps
# walk 16-token tiles (csrc/paged_warp_walk.cuh)
MAX_SPLITS = 8
TILE_TOKENS = 16
WALK_WARPS = 4
TILES_PER_WARP = 8       # a few tiles past the three in flight in a warp's ring
RESIDENT_CTAS_PER_SM = 4  # 52 KB of rings a CTA at hd 128: four fit an SM

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
_LEGACY_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _num_sms(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def group_slices(group: int) -> int:
    """CTAs one (sequence, kv head) takes in each decode kernel's grid
    (per split, for split-K): its G query heads in slices of SLICE_ROWS."""
    return -(-group // SLICE_ROWS)


def default_num_splits(b: int, hkv: int, nblk: int, bs: int, num_sms: int,
                       group: int = 1) -> int:
    """Splits of each row for split-K. Each split's warps should have a
    few tiles each behind the ones in flight (the table's nblk * bs tokens
    are the host's upper bound of a row), the B * Hkv * slices * nsplit
    CTAs (``group`` = G query heads a kv head, ``group_slices`` of them)
    should stay within about two waves of resident CTAs, and a row's splits
    form one cluster. At the serve's table width (32 pages of 16) that is
    one split; splitting is for long contexts at small batch."""
    tiles = -(-nblk * bs // TILE_TOKENS)
    by_work = tiles // (WALK_WARPS * TILES_PER_WARP)
    ctas = b * hkv * group_slices(group)
    by_card = 2 * num_sms * RESIDENT_CTAS_PER_SM // max(ctas, 1)
    return max(1, min(by_work, by_card, MAX_SPLITS))


def _check(q, k_pages, v_pages, block_tables, ctx_lens):
    if q.dim() != 3 or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError("expected q (B,Hq,hd) and k/v pages (P,bs,Hkv,hd)")
    b, hq, hd = q.shape
    _, bs, hkv, hd_k = k_pages.shape
    if hd_k != hd or hq % hkv:
        raise ValueError(f"head shapes disagree: q {tuple(q.shape)}, "
                         f"pages {tuple(k_pages.shape)}")
    if hd not in HEAD_DIMS or bs not in PAGE_SIZES:
        raise ValueError(f"kernel takes hd in {HEAD_DIMS} and bs in {PAGE_SIZES}; "
                         f"got hd={hd}, bs={bs}")
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

    CPU tensors run the plain version. CUDA tensors launch the kernel
    once: for each (sequence, kv head, slice of at most 8 of its query
    heads) the row's live tiles in ``num_splits`` (1 to 8; by default
    ``default_num_splits``) equal shares, one CTA each, those CTAs one
    cluster that merges their states by log-sum-exp in shared memory. A
    row with ctx = 0 comes out as zeros."""
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
    nsplit = num_splits or default_num_splits(
        b, hkv, nblk, bs, _num_sms(q.device.index or 0), hq // hkv)
    if not 1 <= nsplit <= MAX_SPLITS:
        raise ValueError(f"num_splits must be 1..{MAX_SPLITS} (one cluster), "
                         f"got {nsplit}")
    out = torch.empty_like(q)
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             block_tables.data_ptr(), ctx_lens.data_ptr(), out.data_ptr(),
             b, hq, hkv, hd, bs, nblk, nsplit,
             int(q.dtype == torch.bfloat16),
             torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "paged_attention_splitk")
    paged_attention_splitk.launches += 1
    return out


paged_attention_splitk.launches = 0


def paged_attention(q, k_pages, v_pages, block_tables, ctx_lens):
    """The legacy schedule: q (B,Hq,hd); k/v_pages (P,bs,Hkv,hd);
    block_tables (B,nblk) int32; ctx_lens (B,) int32 -> (B,Hq,hd) in q's
    dtype.

    CPU tensors run the plain version. CUDA tensors launch the kernel, one
    CTA per (sequence, kv head, slice of at most 8 of its query heads),
    normalised in the same launch. In bf16 the
    CTA's four warps walk contiguous shares of the row's live pages with
    asynchronous page loads and merge their running softmaxes at the end;
    in float32 it walks the pages one at a time, as a split-K share does.
    A row with ctx = 0 comes out as zeros."""
    if q.device.type == "cpu":
        return ref_paged_attention(q, k_pages, v_pages, block_tables, ctx_lens)
    if q.device.type != "cuda":
        raise ValueError(f"no paged attention for device {q.device}")
    fn = build.kernel_fn("paged_attention", "paged_attention", _LEGACY_ARGTYPES)
    _check(q, k_pages, v_pages, block_tables, ctx_lens)
    b, hq, hd = q.shape
    _, bs, hkv, _ = k_pages.shape
    out = torch.empty_like(q)
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             block_tables.data_ptr(), ctx_lens.data_ptr(), out.data_ptr(),
             b, hq, hkv, hd, bs, block_tables.shape[1],
             int(q.dtype == torch.bfloat16),
             torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "paged_attention")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
