"""Attention dispatch for the paged runner.

The device of the tensors picks the path, never an option: CPU tensors run
the plain PyTorch versions (``repro_torch/kernels/ref.py``), CUDA tensors
launch the Hopper kernels or the call raises. ``impl`` names the schedule:

* ``"auto"`` — the split-K decode kernel and the chunked prefill kernel;
* ``"pallas"`` — the JAX package's legacy serial-page schedule, not ported
  yet: raises ``NotImplementedError``.

There is no value that sends a CUDA tensor to the plain version, and no
tuning preset: the kernels' launch parameters follow the card they run on.
"""
from __future__ import annotations

from repro_torch.kernels.chunked_prefill import chunked_prefill_attention as _chunked
from repro_torch.kernels.paged_attention import paged_attention_splitk as _splitk

IMPLS = ("auto",)


def check_impl(impl: str) -> None:
    if impl == "pallas":
        raise NotImplementedError(
            "the legacy serial-page paged-attention schedule is not ported yet")
    if impl not in IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}; have {IMPLS}")


def paged_attention(q, k_pages, v_pages, block_tables, ctx_lens, impl="auto"):
    """Decode attention: q (B,Hq,hd); k/v_pages (P,bs,Hkv,hd);
    block_tables (B,nblk) int32; ctx_lens (B,) int32 -> (B,Hq,hd)."""
    check_impl(impl)
    return _splitk(q, k_pages, v_pages, block_tables, ctx_lens)


def chunked_prefill_attention(q, k, v, ctx_len, impl="auto"):
    """Chunk attention: q (Sc,Hq,hd); k/v (T,Hkv,hd); ctx_len int ->
    (Sc,Hq,hd)."""
    check_impl(impl)
    return _chunked(q, k, v, ctx_len)
