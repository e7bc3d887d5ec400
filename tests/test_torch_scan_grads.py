"""The gradients of the port's two scans on the CPU.

The plain backwards (``ref.ref_rglru_scan_bwd``, ``ssd_scan.ssd_chunked_bwd``)
are held against ``jax.vjp`` of the JAX package's plain scans on the same
seeded numpy inputs, in float32 to 1e-5 of each gradient's largest value:
``repro.models.ssm.ssd_chunked`` (the sweep of tests/test_kernels.py, a
padded S as ``ssm_context`` pads it, a slow decay), and the associative scan
of ``repro/models/rglru.py:66`` and ``repro.kernels.ref.ref_rglru_scan``.
The SSD backward kernel's design (``csrc/ssd_scan_bwd.cu``: the dH walk,
the chunk terms with dB and dC summed by head group, the groups' sum) is
mirrored in float64 and held against both, and its launch plan
(``ssd_bwd_plan``) is checked. Then ``torch.autograd.gradcheck`` in float64 on the plain backwards
directly: each under a ``torch.autograd.Function`` whose forward is a
float64 recurrence written here (the port's plain forwards compute in
float32). Last, the dispatch in ``ops``: without a gradient wanted the scans
stay outside their Functions; with one, the serving path's options raise.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.ref import ref_rglru_scan as jrglru  # noqa: E402
from repro.models.ssm import ssd_chunked as jssd  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import rglru_scan as rglru_mod  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd_mod  # noqa: E402
from repro_torch.kernels.ref import ref_rglru_scan, ref_rglru_scan_bwd  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_chunked, ssd_chunked_bwd  # noqa: E402

TOL = 1e-5
# (b, s, h, p, n, chunk): tests/test_kernels.py's SSD sweep
SSD_CASES = [(2, 64, 2, 8, 4, 16), (1, 128, 4, 16, 8, 32), (3, 32, 1, 4, 16, 16)]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Beside five other test workers, one thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, what):
    got, want = got.detach().numpy(), np.asarray(want)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=TOL,
                               atol=TOL * float(np.abs(want).max()), err_msg=what)


def _ssd_inputs(rng, b, s, h, p, n, slow, pad):
    """Seeded inputs of S steps whose last ``pad`` are what ``ssm_context``
    pads a sequence of S - pad tokens with to a chunk multiple: dt = 0
    (decay 1) and zero x, B and C."""
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dta = (-(0.01 if slow else 1.0)
           * np.log1p(np.exp(rng.standard_normal((b, s, h))))).astype(np.float32)
    bm = rng.standard_normal((b, s, n)).astype(np.float32)
    cm = rng.standard_normal((b, s, n)).astype(np.float32)
    for t in (x, dta, bm, cm):
        t[:, s - pad:] = 0.0
    return x, dta, bm, cm


@pytest.mark.parametrize("case", SSD_CASES, ids=str)
@pytest.mark.parametrize("slow", [False, True], ids=["normal", "slow-decay"])
@pytest.mark.parametrize("pad", [0, 11], ids=["whole", "padded"])
def test_ssd_plain_backward_matches_jax_vjp(case, slow, pad):
    """dx, d dt_a, dB and dC of the plain backward against JAX's vjp of
    ``ssd_chunked`` from a zero state, with random cotangents of y and the
    final state. "padded": the last 11 steps are padding, whose y the
    model slices away, so their cotangent is zero."""
    b, s, h, p, n, chunk = case
    rng = np.random.default_rng([b, s, h, p, n, chunk, int(slow), pad])
    x, dta, bm, cm = _ssd_inputs(rng, b, s, h, p, n, slow, pad)
    dy = rng.standard_normal(x.shape).astype(np.float32)
    dy[:, s - pad:] = 0.0
    dfinal = rng.standard_normal((b, h, p, n)).astype(np.float32)
    want = jax.jit(lambda ins, cts: jax.vjp(
        lambda *i: jssd(*i, chunk), *ins)[1](cts))(
        (x, dta, bm, cm), (jnp.asarray(dy), jnp.asarray(dfinal)))
    t = torch.from_numpy
    _, _, states = ssd_chunked(t(x), t(dta), t(bm), t(cm), chunk, return_all_states=True)
    got = ssd_chunked_bwd(t(x), t(dta), t(bm), t(cm), chunk, states, t(dy), t(dfinal))
    for name, g, w in zip(("dx", "d dt_a", "dB", "dC"), got, want):
        assert g.dtype == torch.float32
        _close(g, w, name)


# ------------------------------------------------------------ the kernel's design
def _staged_bwd64(x, dta, bm, cm, chunk, states, dy, dfinal, group):
    """The SSD backward kernel's stages (``csrc/ssd_scan_bwd.cu``) in float64:
    the walk carries only dH across chunks, last first, and keeps it for
    every chunk; then each (chunk, group of ``group`` heads) computes C B^T
    once and its heads' terms from H0 (the saved state before the chunk)
    and dH alone, with dB and dC summed over the group in head order, the
    intra-chunk ones through the group's sum of W D; last, the groups'
    partials summed in group order. Returns (dx, d dt_a, dB, dC)."""
    f = [t.double() for t in (x, dta, bm, cm, states, dy, dfinal)]
    x, dta, bm, cm, states, dy, dfinal = f
    b, s, h, p = x.shape
    n, nc, L = bm.shape[-1], s // chunk, chunk
    dh_end = torch.empty((b, nc, h, p, n), dtype=torch.float64)
    dh = dfinal
    for c in range(nc - 1, -1, -1):
        dh_end[:, c] = dh
        if c > 0:
            rows = slice(c * L, (c + 1) * L)
            a = torch.cumsum(dta[:, rows], 1)                                  # (b,L,h)
            dh = (torch.exp(a[:, -1])[..., None, None] * dh
                  + torch.einsum("blhp,blh,bln->bhpn", dy[:, rows], torch.exp(a), cm[:, rows]))
    groups = -(-h // group)
    db_part = torch.zeros((groups, b, s, n), dtype=torch.float64)
    dc_part = torch.zeros_like(db_part)
    dx, d_dta = torch.zeros_like(x), torch.zeros_like(dta)
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool))
    for c in range(nc):
        rows = slice(c * L, (c + 1) * L)
        bc, cc = bm[:, rows], cm[:, rows]                                      # (b,L,n)
        g = torch.einsum("bln,bsn->bls", cc, bc)
        for gi in range(groups):
            wd_sum = torch.zeros((b, L, L), dtype=torch.float64)
            for hh in range(gi * group, min(h, (gi + 1) * group)):
                xs, ys = x[:, rows, hh], dy[:, rows, hh]                       # (b,L,p)
                a = torch.cumsum(dta[:, rows, hh], 1)                          # (b,L)
                ea, er = torch.exp(a), torch.exp(a[:, -1:] - a)
                w = torch.where(causal, torch.exp(a[:, :, None] - a[:, None, :]), 0.0)
                h0 = states[:, c - 1, hh] if c > 0 else torch.zeros_like(dh_end[:, c, hh])
                dhc = dh_end[:, c, hh]                                         # (b,p,n)
                u = torch.einsum("bsn,bpn->bsp", bc, dhc)
                v = torch.einsum("bln,bpn->blp", cc, h0)
                wg = w * g
                d = torch.einsum("blp,bsp->bls", ys, xs)
                m = wg * d
                dx[:, rows, hh] = torch.einsum("bls,blp->bsp", wg, ys) + er[..., None] * u
                st = er * (xs * u).sum(-1)
                da = m.sum(-1) - m.sum(-2) + ea * (ys * v).sum(-1) - st
                da[:, -1] += ea[:, -1] * (dhc * h0).sum((-1, -2)) + st.sum(-1)
                d_dta[:, rows, hh] = torch.flip(torch.cumsum(torch.flip(da, (1,)), 1), (1,))
                db_part[gi, :, rows] += torch.einsum("bs,bsp,bpn->bsn", er, xs, dhc)
                dc_part[gi, :, rows] += torch.einsum("bl,blp,bpn->bln", ea, ys, h0)
                wd_sum += w * d
            db_part[gi, :, rows] += torch.einsum("bls,bln->bsn", wd_sum, cc)
            dc_part[gi, :, rows] += torch.einsum("bls,bsn->bln", wd_sum, bc)
    db, dc = db_part[0].clone(), dc_part[0].clone()
    for gi in range(1, groups):
        db += db_part[gi]
        dc += dc_part[gi]
    return dx, d_dta, db, dc


@functools.lru_cache(maxsize=None)
def _ssd_bwd_case(case, slow, pad):
    """Seeded float64 inputs, the float64 sequential states, and JAX's vjp
    of ``ssd_chunked`` on their float32 values."""
    b, s, h, p, n, chunk = case
    rng = np.random.default_rng([b, s, h, p, n, chunk, int(slow), pad, 64])
    x, dta, bm, cm = _ssd_inputs(rng, b, s, h, p, n, slow, pad)
    dy = rng.standard_normal(x.shape).astype(np.float32)
    dy[:, s - pad:] = 0.0
    dfinal = rng.standard_normal((b, h, p, n)).astype(np.float32)
    want = jax.jit(lambda ins, cts: jax.vjp(
        lambda *i: jssd(*i, chunk), *ins)[1](cts))(
        (x, dta, bm, cm), (jnp.asarray(dy), jnp.asarray(dfinal)))
    ins = [torch.from_numpy(t).double() for t in (x, dta, bm, cm)]
    states = _ssd_sequential64(*ins, chunk)[2]
    return ins, states, torch.from_numpy(dy).double(), torch.from_numpy(dfinal).double(), \
        [np.asarray(w) for w in want]


@pytest.mark.parametrize("group", [1, 2, "all"], ids=lambda g: f"group-{g}")
@pytest.mark.parametrize("case", SSD_CASES, ids=str)
@pytest.mark.parametrize("slow", [False, True], ids=["normal", "slow-decay"])
@pytest.mark.parametrize("pad", [0, 11], ids=["whole", "padded"])
def test_ssd_kernel_design_matches_plain_backward(case, slow, pad, group):
    """The kernel's stages in float64 (the walk, the chunk terms with dB and
    dC summed by head group, the groups' sum) against the plain backward in
    float64 to 1e-10, and against JAX's vjp to 1e-5, for groups of one head,
    two, and all of them."""
    ins, states, dy, dfinal, want = _ssd_bwd_case(case, slow, pad)
    chunk = case[-1]
    g = case[2] if group == "all" else min(group, case[2])
    got = _staged_bwd64(*ins, chunk, states, dy, dfinal, g)
    plain = ssd_chunked_bwd(*ins, chunk, states, dy, dfinal)
    for name, a, pl, w in zip(("dx", "d dt_a", "dB", "dC"), got, plain, want):
        assert a.dtype == pl.dtype == torch.float64
        np.testing.assert_allclose(a.numpy(), pl.numpy(), rtol=1e-10,
                                   atol=1e-10 * float(pl.abs().max()), err_msg=name)
        _close(a.float(), w, name)


def test_ssd_bwd_plan():
    """The backward's three launches: at mamba2-1.3b's training shape two
    walk CTAs a head (32 state rows each), eight head groups a chunk (512
    CTAs), partials 2 x 16.8 MB in place of 2 x 268.4 MB, dh_end
    as large as the saved states; the sweep's heads of 4-16 rows one walk
    slice; a head count that is no multiple of 8 leaves a short last group;
    shapes outside the kernel raise."""
    p = ssd_mod.ssd_bwd_plan(1, 4096, 64, 64, 128, 64)
    assert (p.walk_grid, p.chunk_grid, p.group) == ((2, 64, 1), (8, 64, 1), 8)
    assert (p.dh_end, p.partials) == ((1, 64, 64, 64, 128), (8, 1, 4096, 128))
    assert 4 * np.prod(p.partials) == 16_777_216
    assert 4 * np.prod(p.dh_end) == 134_217_728
    p = ssd_mod.ssd_bwd_plan(2, 64, 2, 8, 4, 16)
    assert (p.walk_grid, p.chunk_grid, p.group, p.partials) == (
        (1, 2, 2), (1, 4, 2), 2, (1, 2, 64, 4))
    p = ssd_mod.ssd_bwd_plan(3, 32, 1, 4, 16, 16)
    assert (p.walk_grid, p.chunk_grid, p.group) == ((1, 1, 3), (1, 2, 3), 1)
    p = ssd_mod.ssd_bwd_plan(2, 96, 12, 64, 128, 32)
    assert (p.walk_grid, p.chunk_grid, p.group, p.partials) == (
        (2, 12, 2), (2, 3, 2), 8, (2, 2, 96, 128))
    for bad in [(1, 64, 2, 32, 16, 16), (1, 64, 2, 64, 129, 16), (1, 128, 2, 64, 16, 128),
                (1, 100, 2, 64, 16, 64), (0, 64, 2, 64, 16, 64)]:
        with pytest.raises(ValueError, match="kernel takes"):
            ssd_mod.ssd_bwd_plan(*bad)


def _jax_assoc_scan(a, b):
    """The RG-LRU scan of repro/models/rglru.py:66."""
    def combine(e1, e2):
        a1, b1 = e1
        a2, b2 = e2
        return a1 * a2, a2 * b1 + b2
    return jax.lax.associative_scan(combine, (a, b), axis=1)[1]


@pytest.mark.parametrize("jfn", [_jax_assoc_scan, jrglru], ids=["assoc-scan", "ref-scan"])
@pytest.mark.parametrize("shape", [(2, 64, 32), (1, 128, 64), (3, 1, 16), (2, 37, 8)],
                         ids=str)
def test_rglru_plain_backward_matches_jax_vjp(shape, jfn):
    """da and db of the plain backward against JAX's vjp, a from a sigmoid
    (the model's decays lie in (0, 1)); S 37 and 1 are off any slab."""
    rng = np.random.default_rng(list(shape))
    a = (1 / (1 + np.exp(-rng.standard_normal(shape)))).astype(np.float32)
    b = rng.standard_normal(shape).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    want = jax.vjp(jfn, jnp.asarray(a), jnp.asarray(b))[1](jnp.asarray(g))
    h = ref_rglru_scan(torch.from_numpy(a), torch.from_numpy(b))
    got = ref_rglru_scan_bwd(torch.from_numpy(a), h, torch.from_numpy(g))
    for name, x, w in zip(("da", "db"), got, want):
        assert x.dtype == torch.float32
        _close(x, w, name)


# ------------------------------------------------------------ gradcheck
def _ssd_sequential64(x, dt_a, b_mat, c_mat, chunk):
    """The token-by-token SSD recurrence in float64 from a zero state:
    (y, final state, the state after every chunk)."""
    bs, s, h, p = x.shape
    state = x.new_zeros((bs, h, p, b_mat.shape[-1]))
    ys, ends = [], []
    for t in range(s):
        state = (state * torch.exp(dt_a[:, t])[..., None, None]
                 + x[:, t, :, :, None] * b_mat[:, t, None, None, :])
        ys.append(torch.einsum("bhpn,bn->bhp", state, c_mat[:, t]))
        if (t + 1) % chunk == 0:
            ends.append(state)
    return torch.stack(ys, 1), state, torch.stack(ends, 1)


class _Ssd64(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt_a, b_mat, c_mat):
        y, final, states = _ssd_sequential64(x, dt_a, b_mat, c_mat, 4)
        ctx.save_for_backward(x, dt_a, b_mat, c_mat, states)
        return y, final

    @staticmethod
    def backward(ctx, dy, dfinal):
        x, dt_a, b_mat, c_mat, states = ctx.saved_tensors
        return ssd_chunked_bwd(x, dt_a, b_mat, c_mat, 4, states, dy, dfinal)


class _Rglru64(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        h, hs = torch.zeros_like(a[:, 0]), []
        for t in range(a.shape[1]):
            h = a[:, t] * h + b[:, t]
            hs.append(h)
        h = torch.stack(hs, 1)
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, g):
        a, h = ctx.saved_tensors
        return ref_rglru_scan_bwd(a, h, g)


def test_ssd_plain_backward_gradcheck():
    """Two batch rows, four chunks of 4, two heads: small, since gradcheck
    evaluates the scan twice per input element."""
    gen = torch.Generator().manual_seed(1)

    def r(*shape):
        return torch.randn(shape, generator=gen, dtype=torch.float64)
    ins = [r(2, 16, 2, 2), -torch.nn.functional.softplus(r(2, 16, 2)), r(2, 16, 2),
           r(2, 16, 2)]
    assert torch.autograd.gradcheck(_Ssd64.apply, [t.requires_grad_() for t in ins])
    got = ssd_chunked_bwd(*ins, 4, _ssd_sequential64(*ins, 4)[2], r(2, 16, 2, 2),
                          r(2, 2, 2, 2))
    assert all(t.dtype == torch.float64 for t in got)


def test_rglru_plain_backward_gradcheck():
    gen = torch.Generator().manual_seed(2)
    a = torch.rand((2, 9, 4), generator=gen, dtype=torch.float64).requires_grad_()
    b = torch.randn((2, 9, 4), generator=gen, dtype=torch.float64).requires_grad_()
    assert torch.autograd.gradcheck(_Rglru64.apply, (a, b))


def test_plain_forwards_keep_float32():
    """The plain forward scans compute in float32 from any input, float64
    included, as before the backwards were added."""
    a = torch.rand((1, 8, 2), dtype=torch.float64)
    assert ref_rglru_scan(a, a).dtype == torch.float32
    x = torch.randn((1, 8, 2, 4), dtype=torch.float64)
    bm = torch.randn((1, 8, 3), dtype=torch.float64)
    y, final = ssd_chunked(x, -a, bm, bm, 4)
    assert y.dtype == final.dtype == torch.float32


# ------------------------------------------------------------ dispatch
def _ssd_args(requires_grad):
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((1, 16, 2, 4), generator=gen).requires_grad_(requires_grad)
    d = -torch.rand((1, 16, 2), generator=gen)
    bm = torch.randn((1, 16, 3), generator=gen)
    return x, d, bm


def test_scans_without_grad_stay_outside_the_functions(monkeypatch):
    """Serving wants no gradient: no Function, nothing saved, one forward."""
    def trip(*a, **k):
        raise AssertionError("a Function was entered without a gradient wanted")
    monkeypatch.setattr(rglru_mod.RglruScanFn, "apply", trip)
    monkeypatch.setattr(ssd_mod.SsdScanFn, "apply", trip)
    a = torch.rand((1, 8, 4), requires_grad=True)
    x, d, bm = _ssd_args(True)
    with torch.no_grad():
        assert ops.rglru_scan(a, a).grad_fn is None
        assert ops.ssd_scan(x, d, bm, bm, chunk=8)[0].grad_fn is None
    with torch.inference_mode():
        ops.ssd_scan(x, d, bm, bm, chunk=8, initial_state=torch.zeros(1, 2, 4, 3),
                     return_all_states=True)
    assert ops.rglru_scan(a.detach(), a.detach()).grad_fn is None
    ops.ssd_scan(x.detach(), d, bm, bm, chunk=8, return_all_states=True)


def test_scans_with_grad_enter_the_functions():
    a = torch.rand((1, 8, 4), requires_grad=True)
    assert type(ops.rglru_scan(a, a).grad_fn).__name__ == "RglruScanFnBackward"
    x, d, bm = _ssd_args(True)
    y, final = ops.ssd_scan(x, d, bm, bm, chunk=8)
    assert type(y.grad_fn).__name__ == "SsdScanFnBackward"
    want = ssd_chunked(x.detach(), d, bm, bm, 8)
    torch.testing.assert_close(y.detach(), want[0], rtol=0, atol=0)
    torch.testing.assert_close(final.detach(), want[1], rtol=0, atol=0)


@pytest.mark.parametrize("kw", [dict(return_all_states=True),
                                dict(initial_state="zeros"),
                                dict(initial_state="grad")], ids=str)
def test_ssd_serving_options_with_grad_raise(kw):
    """The gradient covers the training path's call: from a zero state,
    with no per-chunk states. An initial state, one that wants a gradient
    included, or return_all_states raises once a gradient is wanted."""
    x, d, bm = _ssd_args(True)
    init = kw.pop("initial_state", None)
    if init is not None:
        kw["initial_state"] = torch.zeros((1, 2, 4, 3), requires_grad=init == "grad")
        if init == "grad":
            x = x.detach()
    with pytest.raises(ValueError, match="zero state"):
        ops.ssd_scan(x, d, bm, bm, chunk=8, **kw)


def test_function_gradients_keep_input_dtypes():
    """bfloat16 B and C (the model's dtype) get bfloat16 gradients; the
    scans compute in float32 as the kernels do."""
    x = torch.randn((1, 16, 2, 4), requires_grad=True)
    d = (-torch.rand((1, 16, 2))).requires_grad_()
    bm = torch.randn((1, 16, 3), dtype=torch.bfloat16, requires_grad=True)
    y, final = ops.ssd_scan(x, d, bm, bm, chunk=8)
    assert y.dtype == final.dtype == torch.float32
    gx, gd, gb = torch.autograd.grad((y.sum() + final.sum()), (x, d, bm))
    assert (gx.dtype, gd.dtype, gb.dtype) == (torch.float32, torch.float32, torch.bfloat16)
    a = torch.rand((1, 8, 4), dtype=torch.bfloat16, requires_grad=True)
    ga, = torch.autograd.grad(ops.rglru_scan(a, a).sum(), (a,))
    assert ga.dtype == torch.bfloat16


def test_rglru_bwd_plan():
    """The backward's slabs: one slab rounded up to 16 steps when S fits in
    128, else 128-step slabs through two stages; a, g and h in shared
    memory; rows of W not a whole number of 16-byte copies raise."""
    p = rglru_mod.rglru_bwd_plan(1, 37, 4096, torch.float32)
    assert (p.grid, p.rows, p.slabs, p.stages, p.smem) == ((128, 1), 48, 1, 1, 48 * 32 * 12)
    p = rglru_mod.rglru_bwd_plan(2, 4096, 4104, torch.bfloat16)
    assert (p.grid, p.rows, p.slabs, p.stages, p.smem) == ((129, 2), 128, 32, 2,
                                                           2 * 128 * 32 * 10)
    with pytest.raises(ValueError, match="16 bytes"):
        rglru_mod.rglru_bwd_plan(1, 8, 4097, torch.float32)
