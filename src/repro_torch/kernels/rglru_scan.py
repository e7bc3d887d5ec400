"""RG-LRU linear-recurrence scan: the CUDA kernel's wrapper and launch plan.

The kernel (``csrc/rglru_scan.cu``) replaces the TPU kernel
``repro/kernels/rglru_scan.py::rglru_scan``; its source note says what
bounds it on the card (bytes) and how the design answers that: a CTA owns
32 channels and streams the whole sequence once through a ring of
shared-memory slabs, so a and b are read from device memory once.
``rglru_plan`` picks the slabs and the ring. Its plain version is
``ref.ref_rglru_scan``, the token-by-token recurrence: a CPU tensor goes
there, a CUDA tensor goes to the kernel or the call raises.

The backward (``csrc/rglru_scan_bwd.cu``, port-only: the JAX package
differentiates its XLA associative scan, ``repro/models/rglru.py:66``)
walks the same ring last slab first; ``rglru_bwd_plan`` lays it out and
``ref.ref_rglru_scan_bwd`` is its plain version, chosen by device in the
same way. ``RglruScanFn`` joins the two for autograd.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import ref_rglru_scan, ref_rglru_scan_bwd

CHANNELS = 32            # channels a CTA owns: one per lane
WARPS = 16               # sub-chunks of a slab, one per warp: 512 threads a CTA
SLAB_BYTES = 32 << 10    # a and b of one slab
STAGES = 2               # ring buffers when S takes more than one slab
SMEM_LIMIT = 232448      # shared memory a CTA may use on Hopper
STATIC_SMEM = 2 * WARPS * (CHANNELS + 1) * 4   # the kernel's (p, e) arrays
ROW_ALIGN = 16           # bytes: the kernel copies rows 16 bytes at a time

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_EMPTY_ARGTYPES = [ctypes.c_int] * 3 + [ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
BWD_ROWS = 128           # steps of a backward slab: a, g and h, 48 KB in float32


@dataclasses.dataclass(frozen=True)
class RglruPlan:
    grid: tuple          # CTAs: (channel tiles, batch rows)
    rows: int            # steps of a slab, a multiple of WARPS
    slabs: int           # ceil(S / rows)
    stages: int          # ring buffers in shared memory
    smem: int            # dynamic shared memory, bytes


def _item(w: int, dtype) -> int:
    """a's element size; raises ValueError unless a row of W of them is a
    whole number of the kernels' 16-byte copies."""
    item = 4 if dtype == torch.float32 else 2
    if w * item % ROW_ALIGN:
        raise ValueError(f"the kernel copies rows 16 bytes at a time: W * "
                         f"{item} bytes must be a multiple of {ROW_ALIGN} "
                         f"(W a multiple of {ROW_ALIGN // item}); got W={w}")
    return item


def rglru_plan(b: int, s: int, w: int, dtype) -> RglruPlan:
    """The launch of the scan over a, b (B,S,W) of ``dtype`` (float32 or
    bfloat16): a CTA per 32 channels of a batch row (128 at W 4096, one
    wave on 132 SMs). A slab holds SLAB_BYTES of a and b (128 steps in
    float32, 256 in bfloat16), so S up to that is one slab read at once;
    longer S streams through a ring of STAGES slabs, the next one in flight
    while one is scanned. Raises ValueError where the kernel's 16-byte
    copies would not fit the rows (W * itemsize not a multiple of 16)."""
    item = _item(w, dtype)
    max_rows = SLAB_BYTES // (2 * CHANNELS * item)
    if s <= max_rows:
        rows, stages = -(-s // WARPS) * WARPS, 1
    else:
        rows, stages = max_rows, STAGES
    return RglruPlan(grid=(-(-w // CHANNELS), b), rows=rows, slabs=-(-s // rows),
                     stages=stages, smem=stages * 2 * rows * CHANNELS * item)


def rglru_bwd_plan(b: int, s: int, w: int, dtype) -> RglruPlan:
    """The backward's launch over a (B,S,W) of ``dtype`` with float32 h and
    g: the forward's grid, slabs of BWD_ROWS steps of a, g and h (one slab
    rounded up to WARPS steps when S fits), two stages past one slab.
    Raises ValueError where the 16-byte copies would not fit the rows."""
    item = _item(w, dtype)
    if s <= BWD_ROWS:
        rows, stages = -(-s // WARPS) * WARPS, 1
    else:
        rows, stages = BWD_ROWS, STAGES
    return RglruPlan(grid=(-(-w // CHANNELS), b), rows=rows, slabs=-(-s // rows),
                     stages=stages, smem=stages * rows * CHANNELS * (item + 8))


def rglru_flops(b: int, s: int, w: int) -> int:
    """Operations of the scan: a multiply and an add a step and channel."""
    return 2 * b * s * w


def rglru_bwd_flops(b: int, s: int, w: int) -> int:
    """Operations of its adjoint a step and channel: the carried adjoint's
    multiply-add (lam_t = g_t + a_{t+1} lam_{t+1}) and da_t = lam_t h_{t-1}."""
    return 3 * b * s * w


def _check(a, b):
    if a.dim() != 3 or a.shape != b.shape:
        raise ValueError(f"expected a and b of one shape (B,S,W); got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if min(a.shape) < 1:
        raise ValueError(f"kernel takes B, S, W >= 1; got {tuple(a.shape)}")
    if a.dtype not in (torch.float32, torch.bfloat16) or b.dtype != a.dtype:
        raise ValueError(f"a and b must share float32 or bfloat16; got "
                         f"{a.dtype} and {b.dtype}")
    if b.device != a.device:
        raise ValueError("a and b must be on one device")


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def _aligned(t):
    """``t`` contiguous at a 16-byte aligned address: a view that starts
    inside its buffer is copied, never read misaligned."""
    t = t.contiguous()
    return t if t.data_ptr() % ROW_ALIGN == 0 else t.clone()


def rglru_scan(a, b):
    """a, b (B,S,W) -> h (B,S,W) float32 with h_t = a_t h_{t-1} + b_t from
    h = 0, elementwise over W.

    CPU tensors run the plain version. CUDA tensors launch the kernel on
    contiguous, 16-byte aligned operands (a view that starts inside its
    buffer is copied first), bfloat16 or float32 as given, with
    ``rglru_plan``'s slabs; any S >= 1. Raises ValueError for a W whose
    rows are not a multiple of 16 bytes.

    ``meta`` tensors (a dry run's shape-only trace) take the CUDA route up
    to the launch (the plan's checks, the aligned copies, an empty h) and
    add ``rglru_flops`` to ``rglru_scan.meta_flops`` and the bytes of a, b
    and h to ``rglru_scan.meta_bytes``; nothing is launched."""
    if a.device.type == "cpu":
        return ref_rglru_scan(a, b)
    if a.device.type not in ("cuda", "meta"):
        raise ValueError(f"no RG-LRU scan for device {a.device}")
    fn = build.kernel_fn("rglru_scan", "rglru_scan", _ARGTYPES) if a.device.type == "cuda" else None
    _check(a, b)
    bsz, s, w = a.shape
    plan = rglru_plan(bsz, s, w, a.dtype)
    operand_bytes = _nbytes(a, b)
    a, b = _aligned(a), _aligned(b)
    h = torch.empty((bsz, s, w), dtype=torch.float32, device=a.device)
    if a.device.type == "meta":
        rglru_scan.meta_flops += rglru_flops(bsz, s, w)
        rglru_scan.meta_bytes += operand_bytes + _nbytes(h)
        return h
    err = fn(a.data_ptr(), b.data_ptr(), h.data_ptr(), bsz, s, w, plan.rows,
             plan.stages, plan.smem, int(a.dtype == torch.bfloat16),
             torch.cuda.current_stream(a.device).cuda_stream)
    build.check(err, "rglru_scan")
    rglru_scan.launches += 1
    return h


rglru_scan.launches = 0
rglru_scan.meta_flops = 0
rglru_scan.meta_bytes = 0


def rglru_scan_bwd(a, h, g):
    """The adjoint of ``rglru_scan``: a (B,S,W), its output h (B,S,W)
    float32 and g = dL/dh -> (da, db) in a's dtype.

    CPU tensors run the plain backward. CUDA tensors launch the backward
    kernel on contiguous, 16-byte aligned operands (h and g float32), with
    ``rglru_bwd_plan``'s slabs. ``meta`` tensors take the CUDA route up to
    the launch (the plan's checks, the float32 and aligned copies, empty
    outputs) and add ``rglru_bwd_flops`` and the bytes of a, h, g and the
    outputs to ``rglru_scan_bwd.meta_flops`` and ``meta_bytes``."""
    if a.device.type == "cpu":
        da, db = ref_rglru_scan_bwd(a, h, g)
        return da.to(a.dtype), db.to(a.dtype)
    if a.device.type not in ("cuda", "meta"):
        raise ValueError(f"no RG-LRU scan backward for device {a.device}")
    fn = (build.kernel_fn("rglru_scan_bwd", "rglru_scan_bwd", _BWD_ARGTYPES)
          if a.device.type == "cuda" else None)
    _check(a, a)
    if h.shape != a.shape or g.shape != a.shape or h.device != a.device \
            or g.device != a.device:
        raise ValueError(f"h and g must match a {tuple(a.shape)} on {a.device}")
    bsz, s, w = a.shape
    plan = rglru_bwd_plan(bsz, s, w, a.dtype)
    operand_bytes = _nbytes(a, h, g)
    a = _aligned(a)
    h, g = _aligned(h.float()), _aligned(g.float())
    da = torch.empty((bsz, s, w), dtype=a.dtype, device=a.device)
    db = torch.empty_like(da)
    if a.device.type == "meta":
        rglru_scan_bwd.meta_flops += rglru_bwd_flops(bsz, s, w)
        rglru_scan_bwd.meta_bytes += operand_bytes + _nbytes(da, db)
        return da, db
    err = fn(a.data_ptr(), h.data_ptr(), g.data_ptr(), da.data_ptr(), db.data_ptr(),
             bsz, s, w, plan.rows, plan.stages, plan.smem,
             int(a.dtype == torch.bfloat16),
             torch.cuda.current_stream(a.device).cuda_stream)
    build.check(err, "rglru_scan_bwd")
    rglru_scan_bwd.launches += 1
    return da, db


rglru_scan_bwd.launches = 0
rglru_scan_bwd.meta_flops = 0
rglru_scan_bwd.meta_bytes = 0


class RglruScanFn(torch.autograd.Function):
    """``rglru_scan`` with its gradient: the forward saves a and h, the
    backward runs ``rglru_scan_bwd``, each on the kernel or the plain
    version by device."""

    @staticmethod
    def forward(ctx, a, b):
        h = rglru_scan(a, b)
        ctx.save_for_backward(a, h)
        ctx.b_dtype = b.dtype
        return h

    @staticmethod
    def backward(ctx, g):
        a, h = ctx.saved_tensors
        da, db = rglru_scan_bwd(a, h, g)
        return da.contiguous(), db.to(ctx.b_dtype).contiguous()


def empty_launch(b: int, w: int, plan: RglruPlan, device) -> None:
    """Launch an empty kernel on ``plan``'s grid, block and shared memory:
    the floor under the scan's time. Not counted as a scan launch."""
    fn = build.kernel_fn("rglru_scan", "rglru_empty", _EMPTY_ARGTYPES)
    build.check(fn(b, w, plan.smem, torch.cuda.current_stream(device).cuda_stream),
                "rglru_empty")
