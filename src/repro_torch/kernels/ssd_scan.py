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
by device in the same way. Its source note says what bounds it (operations,
on the tensor cores in 3xTF32) and how the design answers that: only the
adjoint of the carried state walks the chunks in order, in one launch;
everything else runs chunk-parallel in a second, with C·Bᵀ computed once
for a group of heads and dB, dC summed over the group on chip; a third
sums the groups in a fixed order. ``ssd_bwd_plan`` lays the launches out
(the CPU tests check it). ``SsdScanFn`` joins forward and backward for
autograd; it covers the training path's call, which starts from a zero
state and asks for no per-chunk states.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import NEG_INF

HEAD_DIMS = (4, 8, 16, 64)       # P: the Pallas sweep's and mamba2's
MAX_STATE = 128                  # N
MAX_CHUNK = 64                   # L

_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


# ------------------------------------------------------------ work counts
def ssd_fwd_flops(b, s, h, p, n, chunk):
    """Operations of the SSD forward on the causal half of each chunk: C.B^T
    once a chunk (B and C are shared by the heads), and per head (W G) x,
    the entering state's part of y and the state update."""
    tri = chunk * (chunk + 1) // 2                 # causal (s, t) pairs of a chunk
    return 2 * b * (s // chunk) * (tri * n + h * (tri * p + 2 * chunk * n * p))


def ssd_bwd_work(b, s, h, p, n, chunk):
    """Bytes and operations of the SSD backward: each input read once (x,
    dt_a, B, C, the per-chunk states, dy, d final state) and each output
    written once (dx, d dt_a, dB, dC); the multiply-adds the function needs
    on the causal half of each chunk. Once a chunk, since B and C are shared
    by the heads: G = C.B^T, and dB's and dC's intra-chunk products with the
    heads' sum of W D. Per head: D = dy x^T, (W G)^T dy and four state-sized
    products (dH B, x dH, dy H0, the carried dH); d dt_a's dy.(H0 C) term is
    dy H0 dotted with C. Also returns the operations of a wider count, for
    comparison with it: the W D products per head and H0 C a fifth
    state-sized product."""
    nc = s // chunk
    elems = 3 * b * s * h * p + 2 * b * s * h + 4 * b * s * n + (nc + 1) * b * h * p * n
    tri = chunk * (chunk + 1) // 2
    macs = b * nc * (3 * tri * n + h * (2 * tri * p + 4 * chunk * p * n))
    wide = b * nc * (tri * n + h * (2 * tri * n + 2 * tri * p + 5 * chunk * p * n))
    return 4 * elems, 2 * macs, 2 * wide


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


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


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
    cluster.

    ``meta`` tensors (a dry run's shape-only trace) get empty outputs of
    the kernel's shapes and dtypes; nothing is computed, and the kernel's
    operations (``ssd_fwd_flops``) are added to ``ssd_scan.meta_flops``, and
the bytes of its operands and outputs to ``ssd_scan.meta_bytes``."""
    if x.device.type == "cpu":
        return ssd_chunked(x, dt_a, b_mat, c_mat, chunk,
                           initial_state=initial_state,
                           return_all_states=return_all_states)
    if x.device.type == "meta":
        _check(x, dt_a, b_mat, c_mat, chunk, initial_state)
        bsz, s, h, p = x.shape
        n = b_mat.shape[-1]
        ssd_scan.meta_flops += ssd_fwd_flops(bsz, s, h, p, n, chunk)
        out = (torch.empty((bsz, s, h, p), dtype=torch.float32, device=x.device),
               torch.empty((bsz, h, p, n), dtype=torch.float32, device=x.device))
        if return_all_states:
            out += (torch.empty((bsz, s // chunk, h, p, n), dtype=torch.float32,
                                device=x.device),)
        ssd_scan.meta_bytes += _nbytes(x, dt_a, b_mat, c_mat, initial_state, *out)
        return out
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
ssd_scan.meta_flops = 0
ssd_scan.meta_bytes = 0


# ------------------------------------------------------------ the backward
BWD_WALK_ROWS = 32       # state rows of a walk CTA
BWD_GROUP = 8            # most heads a chunk CTA owns


@dataclasses.dataclass(frozen=True)
class SsdBwdPlan:
    walk_grid: tuple     # (P / BWD_WALK_ROWS slices, H, B): CTAs of the dH walk
    chunk_grid: tuple    # (head groups, S / chunk, B): CTAs of the chunk terms
    group: int           # heads a chunk CTA owns (the last group may hold fewer)
    dh_end: tuple        # the adjoint of the state leaving each chunk
    partials: tuple      # dB's and dC's partials, one (B,S,N) a head group


def ssd_bwd_plan(b: int, s: int, h: int, p: int, n: int, chunk: int) -> SsdBwdPlan:
    """The three launches of the backward kernel at x (B,S,H,P), B/C (B,S,N)
    and ``chunk``: the dH walk, one CTA per (batch, head, BWD_WALK_ROWS
    state rows); the chunk terms, one CTA per (batch, chunk, group of up to
    BWD_GROUP heads); and the sum of the groups' dB and dC partials. What
    the wrapper decides: the head group and the buffers it allocates. The
    kernels' shared memory is their own (``csrc/ssd_scan_bwd.cu``
    ``WalkLayout``, ``ChunkLayout``). Raises ValueError outside the
    kernel's shapes."""
    if p not in HEAD_DIMS or not 1 <= n <= MAX_STATE or not 1 <= chunk <= MAX_CHUNK \
            or s < 1 or s % chunk or b < 1 or h < 1:
        raise ValueError(f"kernel takes P in {HEAD_DIMS}, N <= {MAX_STATE} and S a "
                         f"positive multiple of the chunk <= {MAX_CHUNK}; got B={b}, "
                         f"S={s}, H={h}, P={p}, N={n}, chunk={chunk}")
    group = min(BWD_GROUP, h)
    groups = -(-h // group)
    return SsdBwdPlan(walk_grid=(-(-p // BWD_WALK_ROWS), h, b),
                      chunk_grid=(groups, s // chunk, b), group=group,
                      dh_end=(b, s // chunk, h, p, n), partials=(groups, b, s, n))


def ssd_scan_bwd(x, dt_a, b_mat, c_mat, chunk, states, dy, dfinal):
    """The adjoint of ``ssd_scan`` from a zero initial state, given the
    state after every chunk (``states`` (B,S/chunk,H,P,N), the forward's
    ``return_all_states`` output), dy (B,S,H,P) and dfinal (B,H,P,N).
    Returns (dx, d dt_a, dB, dC), float32.

    CPU tensors run the plain backward. CUDA tensors launch the kernel on
    contiguous, 16-byte aligned float32 operands, laid out by
    ``ssd_bwd_plan``: the walk writes the adjoint of every chunk's final
    state into a (B,S/chunk,H,P,N) buffer, the chunk-parallel launch writes
    dx and d dt_a and each head group's dB and dC, and a third sums the
    groups in a fixed order (bitwise-equal results run to run). ``meta``
    tensors get empty outputs and add ``ssd_bwd_work``'s operations and
    bytes to ``ssd_scan_bwd.meta_flops`` and ``meta_bytes``."""
    if x.device.type == "cpu":
        return ssd_chunked_bwd(x, dt_a, b_mat, c_mat, chunk, states, dy, dfinal)
    if x.device.type == "meta":
        _check(x, dt_a, b_mat, c_mat, chunk, None)
        bsz, s, h, p = x.shape
        n = b_mat.shape[-1]
        nbytes, flops, _ = ssd_bwd_work(bsz, s, h, p, n, chunk)
        ssd_scan_bwd.meta_flops += flops
        ssd_scan_bwd.meta_bytes += nbytes
        return tuple(torch.empty(shape, dtype=torch.float32, device=x.device)
                     for shape in ((bsz, s, h, p), (bsz, s, h), (bsz, s, n), (bsz, s, n)))
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
    plan = ssd_bwd_plan(bsz, s, h, p, n, chunk)
    x, dt_a, b_mat, c_mat, states, dy, dfinal = (
        _aligned(t) for t in (x, dt_a, b_mat, c_mat, states, dy, dfinal))
    f32 = dict(dtype=torch.float32, device=x.device)
    dh_end = torch.empty(plan.dh_end, **f32)
    db_part = torch.empty(plan.partials, **f32)
    dc_part = torch.empty(plan.partials, **f32)
    dx = torch.empty_like(x)
    d_dta = torch.empty((bsz, s, h), **f32)
    db = torch.empty((bsz, s, n), **f32)
    dc = torch.empty((bsz, s, n), **f32)
    err = fn(x.data_ptr(), dt_a.data_ptr(), b_mat.data_ptr(), c_mat.data_ptr(),
             states.data_ptr(), dy.data_ptr(), dfinal.data_ptr(), dh_end.data_ptr(),
             dx.data_ptr(), d_dta.data_ptr(), db_part.data_ptr(), dc_part.data_ptr(),
             db.data_ptr(), dc.data_ptr(), bsz, s, h, p, n, chunk, plan.group,
             torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "ssd_scan_bwd")
    ssd_scan_bwd.launches += 1
    return dx, d_dta, db, dc


ssd_scan_bwd.launches = 0
ssd_scan_bwd.meta_flops = 0
ssd_scan_bwd.meta_bytes = 0


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
        # contiguous, as the kernel writes them (the plain backward's are
        # permuted), so that a mesh's shards of them read alike
        return (dx.to(x.dtype).contiguous(), dta.to(dt_a.dtype).contiguous(),
                db.to(b_mat.dtype).contiguous(), dc.to(c_mat.dtype).contiguous(), None)
