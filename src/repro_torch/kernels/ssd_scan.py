"""Mamba-2 SSD chunk scan: the plain chunked version and the CUDA kernel's
wrapper.

The kernel (``csrc/ssd_scan.cu``) replaces the TPU kernel
``repro/kernels/ssd_scan.py::ssd_scan``; its source note says what bounds
it on the card and how the design answers that (the products on the
tensor cores in 3xTF32, the next chunk in flight, C·Bᵀ shared by the P
slices of a head). Its
plain version is ``ssd_chunked``, the port of ``repro/models/ssm.py``'s
``ssd_chunked``: a CPU tensor goes there, a CUDA tensor goes to the kernel
or the call raises. Both take an initial state and can return the state
after every chunk, which the state-snapshot runner resumes from and
snapshots at block boundaries. ``ref.ref_ssd_sequential`` is the oracle of
both.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import NEG_INF

HEAD_DIMS = (4, 8, 16, 64)       # P: the Pallas sweep's and mamba2's
MAX_STATE = 128                  # N
MAX_CHUNK = 64                   # L

_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


# ------------------------------------------------------------ plain version
def _segsum(x):
    """x: (..., T) -> (..., T, T) lower-triangular segment sums (else -1e30)."""
    t = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    d = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=x.device))
    return torch.where(mask, d, NEG_INF)


def ssd_chunked(x, dt_a, b_mat, c_mat, chunk, initial_state=None,
                return_all_states=False):
    """Chunked SSD scan.

    x:    (B, S, H, P)   inputs already scaled by dt
    dt_a: (B, S, H)      A * dt  (negative)
    b/c:  (B, S, N)      shared across heads (ngroups = 1)
    initial_state: optional (B, H, P, N) state before the first token
    Returns (y (B,S,H,P), final_state (B,H,P,N)[, states (B,S/chunk,H,P,N)
    after each chunk]). All math fp32.
    """
    if x.is_cuda:
        ssd_chunked.cuda_calls += 1
    bs, s, h, p = x.shape
    n = b_mat.shape[-1]
    assert s % chunk == 0, f"seq {s} not divisible by chunk {chunk}"
    nc = s // chunk
    xc = x.reshape(bs, nc, chunk, h, p).float()
    bc = b_mat.reshape(bs, nc, chunk, n).float()
    cc = c_mat.reshape(bs, nc, chunk, n).float()
    ac = dt_a.reshape(bs, nc, chunk, h).permute(0, 3, 1, 2).float()
    a_cum = torch.cumsum(ac, dim=-1)                               # (B,H,C,L)

    # intra-chunk (quadratic within chunk)
    el = torch.exp(_segsum(ac))                                   # (B,H,C,L,L)
    y_diag = torch.einsum("bcln,bcsn,bhcls,bcshp->bclhp", cc, bc, el, xc)

    # per-chunk output states
    decay_states = torch.exp(a_cum[..., -1:] - a_cum)              # (B,H,C,L)
    states = torch.einsum("bcln,bhcl,bclhp->bchpn", bc, decay_states, xc)

    if initial_state is None:
        init = torch.zeros((bs, 1, h, p, n), dtype=torch.float32, device=x.device)
    else:
        init = initial_state[:, None].float()
    states = torch.cat([init, states], dim=1)                     # (B,C+1,H,P,N)

    # inter-chunk recurrence
    a_chunk = torch.nn.functional.pad(a_cum[..., -1], (1, 0))     # (B,H,C+1)
    decay_chunk = torch.exp(_segsum(a_chunk))                     # (B,H,C+1,C+1)
    new_states = torch.einsum("bhzc,bchpn->bzhpn", decay_chunk, states)
    prev_states, final_state = new_states[:, :-1], new_states[:, -1]

    state_decay_out = torch.exp(a_cum)                            # (B,H,C,L)
    y_off = torch.einsum("bcln,bchpn,bhcl->bclhp", cc, prev_states,
                         state_decay_out)

    y = (y_diag + y_off).reshape(bs, s, h, p)
    if return_all_states:
        return y, final_state, new_states[:, 1:]      # state after each chunk
    return y, final_state


ssd_chunked.cuda_calls = 0


# ------------------------------------------------------------ the kernel
@functools.lru_cache(maxsize=None)
def _num_sms(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def p_slice(b: int, h: int, p: int, num_sms: int) -> int:
    """Rows of the state one CTA carries. The kernel has one CTA of 16
    warps an SM (a chunk of B, C and x double-buffered fills its shared
    memory), and the P slices of a head form a cluster that shares the
    chunk's C·Bᵀ, so more slices cost little: 16 rows when that still fits
    one wave of CTAs, else 32. A head of at most 16 rows is one CTA, padded
    with zeros below 16."""
    if p <= 16:
        return 16
    return 16 if b * h * (p // 16) <= num_sms else 32


def _aligned(t):
    """``t`` contiguous float32 at a 16-byte aligned address (the kernel
    copies rows with 16-byte cp.async and stores 16 bytes at a time)."""
    t = t.float().contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check(x, dt_a, b_mat, c_mat, chunk, initial_state):
    if x.dim() != 4 or dt_a.dim() != 3 or b_mat.dim() != 3 or \
            b_mat.shape != c_mat.shape:
        raise ValueError("expected x (B,S,H,P), dt_a (B,S,H) and b/c (B,S,N)")
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    if tuple(dt_a.shape) != (bsz, s, h) or tuple(b_mat.shape[:2]) != (bsz, s):
        raise ValueError(f"shapes disagree: x {tuple(x.shape)}, dt_a "
                         f"{tuple(dt_a.shape)}, b/c {tuple(b_mat.shape)}")
    if p not in HEAD_DIMS or not 1 <= n <= MAX_STATE or \
            not 1 <= chunk <= MAX_CHUNK or s == 0 or s % chunk:
        raise ValueError(f"kernel takes P in {HEAD_DIMS}, N <= {MAX_STATE} and "
                         f"S a positive multiple of the chunk <= {MAX_CHUNK}; "
                         f"got P={p}, N={n}, S={s}, chunk={chunk}")
    ops = [x, dt_a, b_mat, c_mat]
    if initial_state is not None:
        if tuple(initial_state.shape) != (bsz, h, p, n):
            raise ValueError(f"initial_state must be {(bsz, h, p, n)}, got "
                             f"{tuple(initial_state.shape)}")
        ops.append(initial_state)
    for t in ops:
        if t.device != x.device:
            raise ValueError("all operands must be on one device")


def ssd_scan(x, dt_a, b_mat, c_mat, *, chunk, initial_state=None,
             return_all_states=False):
    """x (B,S,H,P) dt-scaled; dt_a (B,S,H); b/c (B,S,N); optional
    initial_state (B,H,P,N). Returns (y (B,S,H,P) fp32, final_state
    (B,H,P,N) fp32[, states after each chunk (B,S/chunk,H,P,N) fp32]).

    CPU tensors run the plain chunked version. CUDA tensors launch the
    kernel once, on operands cast to contiguous float32 as the plain
    version casts them (B and C come in the model's dtype): one CTA per
    (batch, head, ``p_slice`` rows of the state), the slices of a head one
    cluster."""
    if x.device.type == "cpu":
        return ssd_chunked(x, dt_a, b_mat, c_mat, chunk,
                           initial_state=initial_state,
                           return_all_states=return_all_states)
    if x.device.type != "cuda":
        raise ValueError(f"no SSD scan for device {x.device}")
    fn = build.kernel_fn("ssd_scan", "ssd_scan", _ARGTYPES)
    _check(x, dt_a, b_mat, c_mat, chunk, initial_state)
    x, dt_a, b_mat, c_mat = (_aligned(t) for t in (x, dt_a, b_mat, c_mat))
    if initial_state is not None:
        initial_state = _aligned(initial_state)
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    nc = s // chunk
    y = torch.empty_like(x)
    final = torch.empty((bsz, h, p, n), dtype=torch.float32, device=x.device)
    states = (torch.empty((bsz, nc, h, p, n), dtype=torch.float32,
                          device=x.device) if return_all_states else None)
    ps = p_slice(bsz, h, p, _num_sms(x.device.index or 0))
    err = fn(x.data_ptr(), dt_a.data_ptr(), b_mat.data_ptr(), c_mat.data_ptr(),
             initial_state.data_ptr() if initial_state is not None else None,
             y.data_ptr(), final.data_ptr(),
             states.data_ptr() if states is not None else None,
             bsz, s, h, p, n, chunk, ps,
             torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "ssd_scan")
    ssd_scan.launches += 1
    if return_all_states:
        return y, final, states
    return y, final


ssd_scan.launches = 0
