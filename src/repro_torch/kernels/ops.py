"""Kernel dispatch: attention for the paged runner, the SSD scan for the
state runner, the RG-LRU scan for the hybrid family's prefill.

The device of the tensors picks the path, never an option: CPU tensors run
the plain PyTorch versions (``repro_torch/kernels/ref.py``, and
``ssd_chunked`` in ``repro_torch/kernels/ssd_scan.py``), CUDA tensors launch
the Hopper kernels or the call raises. ``impl`` names the attention
schedule, as in the JAX package:

* ``"auto"`` — the split-K decode kernel and the chunked prefill kernel;
* ``"pallas"`` — the legacy decode kernel (one launch, one CTA per
  sequence and kv head), and the same chunked prefill kernel (the JAX
  package runs its one fused prefill kernel under both names).

There is no value that sends a CUDA tensor to the plain version, and no
tuning preset: the kernels' launch parameters follow the card they run on.

The two scans are differentiable: where an input requires a gradient (and
grad mode is on) they go through their ``torch.autograd.Function``, whose
backward is a kernel on the card and the plain backward on the CPU. With
no gradient wanted the Function is not entered, so serving saves nothing
and launches nothing more.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.chunked_prefill import chunked_prefill_attention as _chunked
from repro_torch.kernels.paged_attention import paged_attention as _legacy
from repro_torch.kernels.paged_attention import paged_attention_splitk as _splitk
from repro_torch.kernels.rglru_scan import RglruScanFn
from repro_torch.kernels.rglru_scan import rglru_scan as _rglru
from repro_torch.kernels.ssd_scan import SsdScanFn
from repro_torch.kernels.ssd_scan import ssd_scan as _ssd

IMPLS = ("auto", "pallas")


def check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}; have {IMPLS}")


def paged_attention(q, k_pages, v_pages, block_tables, ctx_lens, impl="auto"):
    """Decode attention: q (B,Hq,hd); k/v_pages (P,bs,Hkv,hd);
    block_tables (B,nblk) int32; ctx_lens (B,) int32 -> (B,Hq,hd)."""
    check_impl(impl)
    fn = _legacy if impl == "pallas" else _splitk
    return fn(q, k_pages, v_pages, block_tables, ctx_lens)


def chunked_prefill_attention(q, k, v, ctx_len, impl="auto"):
    """Chunk attention: q (Sc,Hq,hd); k/v (T,Hkv,hd); ctx_len int ->
    (Sc,Hq,hd)."""
    check_impl(impl)
    return _chunked(q, k, v, ctx_len)


def ssd_scan(x, dt_a, b_mat, c_mat, *, chunk, initial_state=None,
             return_all_states=False):
    """SSD chunk scan: x (B,S,H,P) dt-scaled; dt_a (B,S,H); b/c (B,S,N);
    optional initial_state (B,H,P,N) -> (y, final_state[, states after
    each chunk]), all float32. Differentiable in x, dt_a, B and C on the
    training path's call only: with a gradient wanted, an
    ``initial_state`` or ``return_all_states`` (the serving path's) raises."""
    if _wants_grad(x, dt_a, b_mat, c_mat, initial_state):
        if initial_state is not None or return_all_states:
            raise ValueError("the SSD scan's gradient starts from a zero state and "
                             "returns no per-chunk states: call with an "
                             "initial_state or return_all_states under torch.no_grad()")
        return SsdScanFn.apply(x, dt_a, b_mat, c_mat, chunk)
    return _ssd(x, dt_a, b_mat, c_mat, chunk=chunk, initial_state=initial_state,
                return_all_states=return_all_states)


def rglru_scan(a, b):
    """RG-LRU recurrence: a, b (B,S,W) -> h (B,S,W) float32, h_t = a_t
    h_{t-1} + b_t from zero. Differentiable in a and b."""
    if _wants_grad(a, b):
        return RglruScanFn.apply(a, b)
    return _rglru(a, b)


def _wants_grad(*tensors):
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)
