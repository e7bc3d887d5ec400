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

On a DTensor (the multi-device layer, ``repro_torch.launch.sharding``)
each scan runs through ``local_map``: the scans are independent per batch
row and per head (per channel for the RG-LRU), so each rank launches the
same kernel, forward and backward, on its shard. A shard of any other dim
(the scanned sequence dim, the head dim P, a pending sum) is gathered by
an explicit ``redistribute`` first, which the dry run counts. B and C are
shared by the heads, so their gradient from a rank's heads is a partial
sum over the `model` ranks (``Partial``).
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

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
    if isinstance(x, DTensor):
        if initial_state is not None or return_all_states:
            raise ValueError("the SSD scan on a DTensor starts from a zero state and "
                             "returns no per-chunk states (the training and prefill call)")
        return _dtensor_ssd_scan(x, dt_a, b_mat, c_mat, chunk)
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
    if isinstance(a, DTensor):
        return _dtensor_rglru_scan(a, b)
    if _wants_grad(a, b):
        return RglruScanFn.apply(a, b)
    return _rglru(a, b)


def _wants_grad(*tensors):
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


# ------------------------------------------------------------ DTensor routes
class _ContiguousGrad(torch.autograd.Function):
    """Identity forward; the gradient leaves contiguous. A gradient that
    leaves a ``local_map`` becomes a DTensor's shard, and DTensor takes the
    shard's layout for the contiguous one it computes for the whole tensor:
    a permuted shard makes a later view of the gradient fail. (The scans'
    Functions hand back contiguous gradients themselves.)"""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def contiguous_grads(*tensors):
    """The local shards inside a ``local_map`` function, each whose
    gradient is wanted through ``_ContiguousGrad`` (a copy only where a
    gradient is not contiguous already)."""
    if not torch.is_grad_enabled():
        return tensors
    return tuple(_ContiguousGrad.apply(t) if t is not None and t.requires_grad else t
                 for t in tensors)


def follow(placements, keep):
    """Per mesh dim, the placement of a tensor laid out after one on
    ``placements``: ``keep`` maps the dim of a ``Shard`` there to this
    tensor's placement; anything else (a ``Replicate``, a pending sum, a
    shard of another dim) gives ``Replicate``."""
    return tuple(keep.get(p.dim, Replicate()) if type(p) is Shard else Replicate()
                 for p in placements)


def as_placements(t, mesh, placements):
    """``t`` as a DTensor on ``placements``: a plain tensor (alike on every
    rank) is taken as replicated; a DTensor elsewhere is redistributed (a
    collective the dry run counts)."""
    if not isinstance(t, DTensor):
        t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
    return t if tuple(t.placements) == tuple(placements) else t.redistribute(mesh, placements)


def _dtensor_ssd_scan(x, dt_a, b_mat, c_mat, chunk):
    """x (B,S,H,P) keeps its batch and head shards; dt_a (B,S,H) follows;
    B and C (B,S,N) keep the batch shard and are whole on the head ranks,
    their gradient a ``Partial`` sum there; y follows x and the final
    state (B,H,P,N) x's batch and head shards."""
    mesh = x.device_mesh
    x_pl = follow(x.placements, {0: Shard(0), 2: Shard(2)})    # dt_a (B,S,H) alike
    bc_pl = follow(x_pl, {0: Shard(0)})
    bc_grad = follow(x_pl, {0: Shard(0), 2: Partial()})
    final_pl = follow(x_pl, {0: Shard(0), 2: Shard(1)})
    fn = local_map(lambda xl, dl, bl, cl: ssd_scan(xl, dl, bl, cl, chunk=chunk),
                   out_placements=(x_pl, final_pl),
                   in_placements=(x_pl, x_pl, bc_pl, bc_pl),
                   in_grad_placements=(x_pl, x_pl, bc_grad, bc_grad),
                   device_mesh=mesh)
    return fn(as_placements(x, mesh, x_pl), as_placements(dt_a, mesh, x_pl),
              as_placements(b_mat, mesh, bc_pl), as_placements(c_mat, mesh, bc_pl))


def _dtensor_rglru_scan(a, b):
    """a, b (B,S,W) keep their batch and channel shards; h follows."""
    mesh = a.device_mesh
    pl = follow(a.placements, {0: Shard(0), 2: Shard(2)})
    fn = local_map(rglru_scan, out_placements=list(pl), in_placements=(pl, pl),
                   device_mesh=mesh)
    return fn(as_placements(a, mesh, pl), as_placements(b, mesh, pl))
