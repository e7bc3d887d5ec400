"""RG-LRU linear-recurrence scan: the CUDA kernel's wrapper.

The kernel (``csrc/rglru_scan.cu``) replaces the TPU kernel
``repro/kernels/rglru_scan.py::rglru_scan``; its source note says what
bounds it on the card (bytes, and at batch 1 the latency of one channel's
chain of steps) and how the design answers that. Its plain version is
``ref.ref_rglru_scan``, the token-by-token recurrence: a CPU tensor goes
there, a CUDA tensor goes to the kernel or the call raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import ref_rglru_scan

CHUNK = 64               # steps per chunk while S <= CHUNK * MAX_CHUNKS
MAX_CHUNKS = 32          # sequence chunks per channel: warps per CTA

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


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


def rglru_scan(a, b):
    """a, b (B,S,W) -> h (B,S,W) float32 with h_t = a_t h_{t-1} + b_t from
    h = 0, elementwise over W.

    CPU tensors run the plain version. CUDA tensors launch the kernel on
    contiguous operands, bfloat16 or float32 as given: each channel's
    sequence in min(32, ceil(S / 64)) chunks scanned side by side, any
    S >= 1."""
    if a.device.type == "cpu":
        return ref_rglru_scan(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"no RG-LRU scan for device {a.device}")
    fn = build.kernel_fn("rglru_scan", "rglru_scan", _ARGTYPES)
    _check(a, b)
    a, b = a.contiguous(), b.contiguous()
    bsz, s, w = a.shape
    nchunk = min(MAX_CHUNKS, -(-s // CHUNK))
    h = torch.empty((bsz, s, w), dtype=torch.float32, device=a.device)
    err = fn(a.data_ptr(), b.data_ptr(), h.data_ptr(), bsz, s, w, nchunk,
             int(a.dtype == torch.bfloat16),
             torch.cuda.current_stream(a.device).cuda_stream)
    build.check(err, "rglru_scan")
    rglru_scan.launches += 1
    return h


rglru_scan.launches = 0
