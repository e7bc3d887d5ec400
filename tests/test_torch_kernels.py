"""The port's plain attention versions against the JAX oracles and the
Pallas kernels (interpret mode), on the cases and tolerances of
tests/test_kernels.py. Inputs come from numpy with a seed; bfloat16 cases
round the same float32 draws to bfloat16 in both frameworks."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.chunked_prefill import chunked_prefill_attention as pallas_chunked  # noqa: E402
from repro.kernels.paged_attention import paged_attention_splitk as pallas_splitk  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.chunked_prefill import chunked_prefill_attention  # noqa: E402
from repro_torch.kernels.paged_attention import (  # noqa: E402
    MAX_SPLITS, default_num_splits, paged_attention_splitk)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}

# (b, hq, hkv, hd, bs, nblk, ctx_lens): the split-K sweep of
# tests/test_kernels.py — GQA groups 1 / 4 / 8, ragged, ctx < one page
PAGED_DECODE_CASES = [
    (2, 4, 4, 32, 8, 4, [32, 17]),
    (3, 8, 2, 64, 16, 6, [96, 5, 48]),
    (2, 8, 1, 32, 8, 5, [40, 3]),
    (4, 4, 1, 16, 4, 3, [12, 1, 7, 9]),
]

# (sc, t, hq, hkv, hd, ctx, blk_q, blk_k): both chunked-prefill sweeps of
# tests/test_kernels.py, divisible tiles first, then tiles that don't divide
CHUNKED_CASES = [
    (64, 128, 4, 2, 32, 0, 32, 32),
    (64, 128, 4, 2, 32, 37, 32, 32),
    (32, 64, 2, 1, 64, 30, 32, 32),
    (100, 420, 4, 1, 32, 250, 32, 64),
    (65, 131, 8, 2, 32, 66, 32, 32),
    (7, 16, 4, 4, 16, 9, 32, 32),
    (64, 192, 8, 8, 32, 128, 16, 48),
]


def _tol(dtype, f32_tol, bf16_tol):
    return bf16_tol if dtype == "bfloat16" else f32_tol


def _both(x, dtype):
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _f32(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else a, np.float32)


def _paged_inputs(seed, b, hq, hkv, hd, bs, nblk, ctx_lens, dtype):
    rng = np.random.default_rng(seed)
    p = nblk * b + 2
    q = rng.standard_normal((b, hq, hd), np.float32)
    kp = rng.standard_normal((p, bs, hkv, hd), np.float32)
    vp = rng.standard_normal((p, bs, hkv, hd), np.float32)
    bt = rng.integers(0, p, (b, nblk)).astype(np.int32)
    cl = np.asarray(ctx_lens, np.int32)
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, dtype) for a in (q, kp, vp))
    return ((jq, jk, jv, jnp.asarray(bt), jnp.asarray(cl)),
            (tq, tk, tv, torch.from_numpy(bt), torch.from_numpy(cl)))


def _chunked_inputs(seed, sc, t, hq, hkv, hd, dtype):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((sc, hq, hd), np.float32)
    k = rng.standard_normal((t, hkv, hd), np.float32)
    v = rng.standard_normal((t, hkv, hd), np.float32)
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, dtype) for a in (q, k, v))
    return (jq, jk, jv), (tq, tk, tv)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", PAGED_DECODE_CASES)
def test_paged_plain_matches_jax_oracle(dtype, case):
    b, hq, hkv, hd, bs, nblk, ctx_lens = case
    jin, tin = _paged_inputs(b * 7 + hq, *case, dtype)
    got = ref.ref_paged_attention(*tin)
    want = jref.ref_paged_attention(*jin)
    assert got.shape == (b, hq, hd) and got.dtype == tin[0].dtype
    tol = _tol(dtype, 2e-4, 2e-2)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", PAGED_DECODE_CASES)
@pytest.mark.parametrize("pages_per_split", [1, 4])
def test_paged_plain_matches_pallas_splitk(dtype, case, pages_per_split):
    jin, tin = _paged_inputs(case[0] * 7 + case[1], *case, dtype)
    got = paged_attention_splitk(*tin)
    want = pallas_splitk(*jin, pages_per_split=pages_per_split, interpret=True)
    tol = _tol(dtype, 2e-4, 2e-2)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", CHUNKED_CASES)
def test_chunked_plain_matches_jax_oracle(dtype, case):
    sc, t, hq, hkv, hd, ctx, _, _ = case
    jin, tin = _chunked_inputs(sc * 3 + ctx, sc, t, hq, hkv, hd, dtype)
    got = ref.ref_chunked_prefill_attention(*tin, ctx)
    want = jref.ref_chunked_prefill_attention(*jin, ctx)
    assert got.shape == tin[0].shape and got.dtype == tin[0].dtype
    tol = _tol(dtype, 2e-5, 3e-2)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", CHUNKED_CASES)
def test_chunked_plain_matches_pallas(dtype, case):
    sc, t, hq, hkv, hd, ctx, blk_q, blk_k = case
    jin, tin = _chunked_inputs(sc * 3 + ctx, sc, t, hq, hkv, hd, dtype)
    got = chunked_prefill_attention(*tin, ctx)
    want = pallas_chunked(*jin, ctx, blk_q=blk_q, blk_k=blk_k, interpret=True)
    tol = _tol(dtype, 2e-4, 3e-2)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


def test_paged_plain_ignores_garbage_pages():
    """Pages not referenced by the block table must not affect output."""
    rng = np.random.default_rng(9)
    q = torch.from_numpy(rng.standard_normal((1, 2, 16), np.float32))
    kp = torch.from_numpy(rng.standard_normal((6, 8, 1, 16), np.float32))
    vp = torch.from_numpy(rng.standard_normal((6, 8, 1, 16), np.float32))
    bt = torch.tensor([[1, 3]], dtype=torch.int32)
    cl = torch.tensor([12], dtype=torch.int32)
    out1 = ops.paged_attention(q, kp, vp, bt, cl)
    kp2, vp2 = kp.clone(), vp.clone()
    kp2[0], kp2[2], vp2[4] = 999.0, -999.0, 123.0
    out2 = ops.paged_attention(q, kp2, vp2, bt, cl)
    torch.testing.assert_close(out1, out2, rtol=1e-6, atol=0)


def test_padded_decode_row_is_finite():
    """ctx = 0 marks a padded decode row; the plain version gives the
    uniform mean there (the kernel gives zeros) — finite either way."""
    jin, tin = _paged_inputs(5, 2, 8, 2, 32, 8, 4, [20, 0], "float32")
    out = ops.paged_attention(*tin)
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(_f32(out[0]), _f32(jref.ref_paged_attention(*jin)[0]),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("b,hkv,nblk,bs,want_splits", [
    (8, 8, 32, 16, 1),      # the serve's table: 32 tiles, one a warp-stage of 8
    (32, 8, 32, 16, 1),     # a full batch at the serve's table width
    (1, 8, 32, 16, 1),      # one short sequence: splitting leaves warps idle
    (1, 8, 128, 16, 4),     # 128 tiles: 4 splits give each warp 8 tiles
    (2, 8, 512, 16, 8),     # long context at small batch: the cluster limit
    (64, 8, 512, 16, 2),    # 512 CTAs a split: two waves of 4 a SM allow 2
    (1, 1, 64, 4, 1),       # 16 tiles of 4-token pages: fewer than 32
    (1, 1, 4096, 16, 8),    # 4096 tiles, 1056 CTAs fit: still one cluster
])
def test_default_split_fills_two_waves(b, hkv, nblk, bs, want_splits):
    assert default_num_splits(b, hkv, nblk, bs, num_sms=132) == want_splits


@pytest.mark.parametrize("b,hkv,nblk,bs", [
    (1, 1, 1 << 16, 16), (1, 8, 8192, 16), (4, 2, 1 << 14, 8), (1, 1, 1 << 15, 4)])
def test_default_split_stays_in_one_cluster(b, hkv, nblk, bs):
    """The splits of a row form one thread-block cluster: never more than
    the portable cluster size, however long the table or idle the card."""
    assert default_num_splits(b, hkv, nblk, bs, num_sms=132) == MAX_SPLITS
    for sms in (1, 16, 132, 1000):
        assert 1 <= default_num_splits(b, hkv, nblk, bs, num_sms=sms) <= MAX_SPLITS
