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

The backward (port-only: the JAX package differentiates its XLA
``ssd_chunked``, ``repro/models/ssm.py:61``) is a kernel too,
``csrc/ssd_scan_bwd.cu``, with ``ssd_chunked_bwd`` its plain version, chosen
by device in the same way. ``SsdScanFn`` joins forward and backward for
autograd; it covers the training path's call, which starts from a zero
state and asks for no per-chunk states.
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
_BWD_ARGTYPES = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


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


def ssd_chunked_bwd(x, dt_a, b_mat, c_mat, chunk, states, dy, dfinal):
    """Adjoint of ``ssd_chunked`` from a zero initial state, given the
    state after every chunk that its forward returned (``states``
    (B,S/chunk,H,P,N)), so nothing is recomputed across chunks. dy
    (B,S,H,P) and dfinal (B,H,P,N) are the gradients of y and of the final
    state. Returns (dx, d dt_a, dB, dC) in float32, or in float64 from
    float64 x (the gradient checks run there).

    Per chunk, with A the running sum of dt_a, W[l,s] = exp(A_l - A_s) for
    s <= l, G = C B^T, D = dy x^T (summed over P), H0 the state entering
    the chunk and dH the adjoint of the state leaving it:
      dx_s   = sum_l W G dy_l + exp(A_L - A_s) dH B_s
      dB_s   = sum_l W D C_l + exp(A_L - A_s) dH^T x_s
      dC_l   = sum_s W D B_s + exp(A_l) H0^T dy_l
      dA_l   = sum_s M[l,s] - sum_l' M[l',l] + exp(A_l) dy_l.(H0 C_l)
               - exp(A_L - A_l) <dH, x_l B_l^T>, M = W G D, and the
               chunk's last position also takes exp(A_L) <dH, H0> and
               sum_s exp(A_L - A_s) <dH, x_s B_s^T>
      dH_in  = exp(A_L) dH + sum_l exp(A_l) dy_l C_l^T
    and d dt_a is the reverse running sum of dA within the chunk. Every
    exponent is of a segment sum that ends after it starts (at most 0):
    no state is rebuilt backwards through exp(-A)."""
    if x.is_cuda:
        ssd_chunked_bwd.cuda_calls += 1
    bs, s, h, p = x.shape
    n = b_mat.shape[-1]
    nc = s // chunk
    dt = torch.float64 if x.dtype == torch.float64 else torch.float32
    xc = x.reshape(bs, nc, chunk, h, p).to(dt)
    dyc = dy.reshape(bs, nc, chunk, h, p).to(dt)
    bc = b_mat.reshape(bs, nc, chunk, n).to(dt)
    cc = c_mat.reshape(bs, nc, chunk, n).to(dt)
    ac = dt_a.reshape(bs, nc, chunk, h).permute(0, 3, 1, 2).to(dt)
    a_cum = torch.cumsum(ac, dim=-1)                               # (B,H,C,L)
    a_last = a_cum[..., -1]                                        # (B,H,C)
    h0 = torch.cat([torch.zeros_like(states[:, :1]), states[:, :-1]],
                   dim=1).to(dt)                                   # (B,C,H,P,N)

    # the adjoint of the state leaving each chunk, walked back across chunks
    q = torch.einsum("bclhp,bhcl,bcln->bchpn", dyc, torch.exp(a_cum), cc)
    dh_end = [dfinal.to(dt)]
    for ci in range(nc - 1, 0, -1):
        dh_end.append(torch.exp(a_last[:, :, ci])[..., None, None] * dh_end[-1]
                      + q[:, ci])
    dh_end = torch.stack(dh_end[::-1], dim=1)                      # (B,C,H,P,N)

    w = torch.exp(_segsum(ac))                                     # (B,H,C,L,L)
    g = torch.einsum("bcln,bcsn->bcls", cc, bc)
    d = torch.einsum("bclhp,bcshp->bhcls", dyc, xc)
    wg = w * g[:, None]
    wd = w * d
    decay_states = torch.exp(a_last[..., None] - a_cum)            # (B,H,C,L)
    decay_out = torch.exp(a_cum)
    u = torch.einsum("bchpn,bcsn->bcshp", dh_end, bc)              # dH B_s
    v = torch.einsum("bchpn,bcln->bclhp", h0, cc)                  # H0 C_l
    dx = (torch.einsum("bhcls,bclhp->bcshp", wg, dyc)
          + decay_states.permute(0, 2, 3, 1)[..., None] * u)
    db = (torch.einsum("bhcls,bcln->bcsn", wd, cc)
          + torch.einsum("bhcs,bchpn,bcshp->bcsn", decay_states, dh_end, xc))
    dc = (torch.einsum("bhcls,bcsn->bcln", wd, bc)
          + torch.einsum("bhcl,bchpn,bclhp->bcln", decay_out, h0, dyc))
    m = wg * d
    s_term = decay_states * torch.einsum("bclhp,bclhp->bhcl", xc, u)
    da = (m.sum(-1) - m.sum(-2)
          + decay_out * torch.einsum("bclhp,bclhp->bhcl", dyc, v) - s_term)
    da[..., -1] += (torch.exp(a_last) * torch.einsum("bchpn,bchpn->bhc", dh_end, h0)
                    + s_term.sum(-1))
    d_dta = torch.flip(torch.cumsum(torch.flip(da, (-1,)), -1), (-1,))
    return (dx.reshape(bs, s, h, p), d_dta.permute(0, 2, 3, 1).reshape(bs, s, h),
            db.reshape(bs, s, n), dc.reshape(bs, s, n))


ssd_chunked_bwd.cuda_calls = 0


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


# ------------------------------------------------------------ the backward
def bwd_p_slice(p: int) -> int:
    """Rows of the state one backward CTA carries: the whole head up to 16
    rows (padded with zeros), else 32 (two CTAs a head at mamba2's P 64,
    one wave of 128 CTAs at B 1, H 64)."""
    return 16 if p <= 16 else 32


def ssd_scan_bwd(x, dt_a, b_mat, c_mat, chunk, states, dy, dfinal):
    """The adjoint of ``ssd_scan`` from a zero initial state, given the
    state after every chunk (``states`` (B,S/chunk,H,P,N), the forward's
    ``return_all_states`` output), dy (B,S,H,P) and dfinal (B,H,P,N).
    Returns (dx, d dt_a, dB, dC), float32.

    CPU tensors run the plain backward. CUDA tensors launch the kernel on
    contiguous float32 operands: one CTA per (batch, head, ``bwd_p_slice``
    rows), then a second launch that sums the heads' and slices' partial
    dB, dC and d dt_a in a fixed order."""
    if x.device.type == "cpu":
        return ssd_chunked_bwd(x, dt_a, b_mat, c_mat, chunk, states, dy, dfinal)
    if x.device.type != "cuda":
        raise ValueError(f"no SSD scan backward for device {x.device}")
    fn = build.kernel_fn("ssd_scan_bwd", "ssd_scan_bwd", _BWD_ARGTYPES)
    _check(x, dt_a, b_mat, c_mat, chunk, None)
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    for name, t, shape in (("states", states, (bsz, s // chunk, h, p, n)),
                           ("dy", dy, (bsz, s, h, p)), ("dfinal", dfinal, (bsz, h, p, n))):
        if tuple(t.shape) != shape or t.device != x.device:
            raise ValueError(f"{name} must be {shape} on {x.device}, got "
                             f"{tuple(t.shape)} on {t.device}")
    x, dt_a, b_mat, c_mat, states, dy, dfinal = (
        t.float().contiguous() for t in (x, dt_a, b_mat, c_mat, states, dy, dfinal))
    ps = bwd_p_slice(p)
    nsl = p // ps if p > ps else 1
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    dta_part = torch.empty((nsl, bsz, s, h), **f32)
    db_part = torch.empty((h * nsl, bsz, s, n), **f32)
    dc_part = torch.empty((h * nsl, bsz, s, n), **f32)
    d_dta = torch.empty((bsz, s, h), **f32)
    db = torch.empty((bsz, s, n), **f32)
    dc = torch.empty((bsz, s, n), **f32)
    err = fn(x.data_ptr(), dt_a.data_ptr(), b_mat.data_ptr(), c_mat.data_ptr(),
             states.data_ptr(), dy.data_ptr(), dfinal.data_ptr(), dx.data_ptr(),
             dta_part.data_ptr(), db_part.data_ptr(), dc_part.data_ptr(),
             d_dta.data_ptr(), db.data_ptr(), dc.data_ptr(),
             bsz, s, h, p, n, chunk, ps, torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "ssd_scan_bwd")
    ssd_scan_bwd.launches += 1
    return dx, d_dta, db, dc


ssd_scan_bwd.launches = 0


class SsdScanFn(torch.autograd.Function):
    """``ssd_scan`` from a zero state with its gradient, y and the final
    state as outputs. The forward runs the scan with ``return_all_states``
    and saves the state after every chunk; the backward runs
    ``ssd_scan_bwd`` from them, each on the kernel or the plain version by
    device. Gradients come back in the inputs' dtypes."""

    @staticmethod
    def forward(ctx, x, dt_a, b_mat, c_mat, chunk):
        y, final, states = ssd_scan(x, dt_a, b_mat, c_mat, chunk=chunk,
                                    return_all_states=True)
        ctx.save_for_backward(x, dt_a, b_mat, c_mat, states)
        ctx.chunk = chunk
        return y, final

    @staticmethod
    def backward(ctx, dy, dfinal):
        x, dt_a, b_mat, c_mat, states = ctx.saved_tensors
        dx, dta, db, dc = ssd_scan_bwd(x, dt_a, b_mat, c_mat, ctx.chunk, states,
                                       dy, dfinal)
        return (dx.to(x.dtype), dta.to(dt_a.dtype), db.to(b_mat.dtype),
                dc.to(c_mat.dtype), None)
