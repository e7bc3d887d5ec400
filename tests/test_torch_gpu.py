"""Card-only tests of the port: each CUDA kernel against its plain PyTorch
version on the card, on the cases of tests/test_kernels.py and at the main
paths' shapes (musicgen-medium's hd 64, 24-head MHA, granite-34b's
48-query-head MQA, and llama4-scout's and qwen2-vl-72b's heads among them), and the engine's tokens on the card against
the CPU, for an attention model and a 48-query-head MQA model (both
decode schedules), a routed MoE model (capacity factors 8.0 and 0.5), a
mamba2 model and a hybrid RG-LRU model, and through the real-time front
door; the MoE layer's routing on the card against the CPU; a prefix
migrated between two paged runners on the card; and the link
calibration of the card's host copies.

They skip without a CUDA device. This file imports no jax, so it also runs
where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.cluster import Replica, Router  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.core import ECHO, SLO, EchoEngine, Request, TaskType  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.chunked_prefill import chunked_prefill_attention  # noqa: E402
from repro_torch.kernels.paged_attention import (  # noqa: E402
    paged_attention, paged_attention_splitk)
from repro_torch.kernels.rglru_scan import rglru_scan  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_chunked, ssd_scan  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.params import tree_map  # noqa: E402

pytestmark = pytest.mark.gpu

DTYPES = [torch.float32, torch.bfloat16]
DECODE_TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
PREFILL_TOL = {torch.float32: 2e-4, torch.bfloat16: 3e-2}
# ||kernel - plain|| / ||plain|| per case: catches an error of a few percent
# over every element, which the elementwise tolerance lets through
REL_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}

PAGED_DECODE_CASES = [
    (2, 4, 4, 32, 8, 4, [32, 17]),
    (3, 8, 2, 64, 16, 6, [96, 5, 48]),
    (2, 8, 1, 32, 8, 5, [40, 3]),
    (4, 4, 1, 16, 4, 3, [12, 1, 7, 9]),
    (8, 32, 8, 128, 16, 32, [512, 1, 17, 300, 64, 511, 250, 0]),   # qwen3-4b
    (8, 32, 8, 128, 16, 32, [100, 87, 120, 95, 101, 81, 116, 0]),  # the serve's
    # a full batch of rows of up to 32 pages: page edges, a full table, ctx 0
    (32, 32, 8, 128, 16, 32, [1, 16, 17, 511, 512, 0, 33, 64, 65, 100, 128, 129,
                              200, 255, 256, 257, 300, 320, 383, 384, 400, 448,
                              449, 480, 500, 2, 15, 31, 32, 48, 97, 510]),
    (2, 8, 2, 64, 16, 4, [5, 3]),        # fewer live pages than a CTA's warps
    # contexts past the table's nblk * bs tokens: only the table's keys count
    (3, 8, 2, 64, 4, 3, [20, 12, 9]),
    (2, 4, 1, 32, 8, 3, [30, 24]),
    # long context at small batch: split-K's default takes a full cluster
    (2, 32, 8, 128, 16, 512, [8192, 0]),
    # two live tiles: with 8 splits most splits walk nothing
    (1, 32, 8, 128, 16, 32, [20]),
    # codeqwen1.5-7b's MHA (G 1) at the serve's contexts and a full table,
    # and the G 8 / Hkv 4 shape of yi-9b and qwen3-moe-30b-a3b
    (8, 32, 32, 128, 16, 32, [100, 87, 120, 95, 101, 81, 116, 0]),
    (8, 32, 32, 128, 16, 32, [512, 1, 17, 300, 64, 511, 250, 0]),
    (8, 32, 4, 128, 16, 32, [100, 87, 120, 95, 101, 81, 116, 0]),
    (8, 32, 4, 128, 16, 32, [512, 1, 17, 300, 64, 511, 250, 0]),
    # musicgen-medium's MHA at hd 64, 24 heads (a count off a power of two):
    # B 1, 8 and 32, at the serve's contexts and up to the table
    (1, 24, 24, 64, 16, 32, [512]),
    (8, 24, 24, 64, 16, 32, [100, 87, 120, 95, 101, 81, 116, 0]),
    (8, 24, 24, 64, 16, 32, [512, 1, 17, 300, 64, 511, 250, 0]),
    (32, 24, 24, 64, 16, 32, [1, 16, 17, 511, 512, 0, 33, 64, 65, 100, 128, 129,
                              200, 255, 256, 257, 300, 320, 383, 384, 400, 448,
                              449, 480, 500, 2, 15, 31, 32, 48, 97, 510]),
    # query groups past 8, in slices of 8 rows: granite-34b's MQA (48 query
    # heads on one kv head, six slices) at B 1, 8 and 32 and at long
    # context; llama4-scout's G 5 (40 on 8), also at long context; G 9
    # and G 12, whose last slice is short (one row, four rows), in bf16's
    # tensor-core walk at hd 128 and 64 and in float32's page walk at
    # 4-token pages
    (1, 48, 1, 128, 16, 32, [512]),
    (8, 48, 1, 128, 16, 32, [100, 87, 120, 95, 101, 81, 116, 0]),
    (32, 48, 1, 128, 16, 32, [1, 16, 17, 511, 512, 0, 33, 64, 65, 100, 128, 129,
                              200, 255, 256, 257, 300, 320, 383, 384, 400, 448,
                              449, 480, 500, 2, 15, 31, 32, 48, 97, 510]),
    (2, 48, 1, 128, 16, 512, [8192, 5000]),
    (8, 40, 8, 128, 16, 32, [100, 87, 120, 95, 101, 81, 116, 0]),
    (8, 40, 8, 128, 16, 32, [512, 1, 17, 300, 64, 511, 250, 0]),
    (2, 40, 8, 128, 16, 512, [8192, 5000]),
    # qwen2-vl-72b's G 8 (64 query heads on 8 kv heads, one full slice) at
    # the serve's contexts, up to the table and at long context
    (8, 64, 8, 128, 16, 32, [100, 87, 120, 95, 101, 81, 116, 0]),
    (8, 64, 8, 128, 16, 32, [512, 1, 17, 300, 64, 511, 250, 0]),
    (2, 64, 8, 128, 16, 512, [8192, 5000]),
    (4, 9, 1, 128, 16, 32, [300, 17, 0, 512]),
    (3, 24, 2, 64, 16, 8, [128, 5, 77]),
    (3, 12, 1, 32, 4, 6, [24, 2, 0]),
]
CHUNKED_CASES = [
    (64, 128, 4, 2, 32, 0), (64, 128, 4, 2, 32, 37), (32, 64, 2, 1, 64, 30),
    (100, 420, 4, 1, 32, 250), (65, 131, 8, 2, 32, 66), (7, 16, 4, 4, 16, 9),
    (64, 192, 8, 8, 32, 128),
    (64, 512, 32, 8, 128, 0), (64, 512, 32, 8, 128, 448),           # qwen3-4b
    (48, 300, 16, 2, 128, 200),       # G 8: 384 packed rows
    (64, 2048, 32, 8, 128, 1984),     # a long prefix through many ring stages
    (1, 40, 4, 1, 64, 39),            # a single query row
    (64, 512, 32, 8, 128, 37),        # a frontier off every tile boundary
    (64, 512, 32, 32, 128, 0), (64, 512, 32, 32, 128, 448),         # codeqwen MHA
    (64, 512, 32, 4, 128, 0), (64, 512, 32, 4, 128, 448),           # G 8, Hkv 4
    # musicgen-medium's MHA at hd 64, 24 heads: one head a tile of 64 rows,
    # and a chunk whose last tile is ragged
    (64, 512, 24, 24, 64, 0), (64, 512, 24, 24, 64, 448), (37, 300, 24, 24, 64, 200),
    # query groups past 8: granite-34b's G 48 (a 64-row tile spans two query
    # positions, one in part), llama4-scout's G 5, G 9 and G 12
    (64, 512, 48, 1, 128, 0), (64, 512, 48, 1, 128, 448), (7, 40, 48, 1, 32, 33),
    (64, 512, 40, 8, 128, 448), (37, 300, 9, 1, 128, 200), (64, 512, 24, 2, 64, 37),
    # llama4-scout's and qwen2-vl-72b's heads (Hq 40 and 64 on Hkv 8): a
    # first chunk, a chunk at the table's end, a ragged chunk
    (64, 512, 40, 8, 128, 0), (37, 300, 40, 8, 128, 200),
    (64, 512, 64, 8, 128, 0), (64, 512, 64, 8, 128, 448), (37, 300, 64, 8, 128, 200),
]

# (b, s, h, p, n, chunk): tests/test_kernels.py's SSD sweep, then mamba2-1.3b
# at batch 1 (the serve's spans are S 64 and 128) and beyond
SSD_CASES = [
    (2, 64, 2, 8, 4, 16), (1, 128, 4, 16, 8, 32), (3, 32, 1, 4, 16, 16),
    (1, 64, 64, 64, 128, 64), (1, 128, 64, 64, 128, 64), (1, 512, 64, 64, 128, 64),
    (2, 256, 64, 64, 128, 64),    # batch 2, four chunks through the double buffer
    (1, 96, 8, 64, 128, 32),      # chunk 32 at mamba2's widths: 16-row slices
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(rng, shape, dtype, dev):
    return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(dev, dtype)


def _assert_rel_close(got, want, dtype):
    got, want = got.float(), want.float()
    rel = torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want)
    assert rel < REL_TOL[dtype], f"relative error {float(rel):.3e}"


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", PAGED_DECODE_CASES)
@pytest.mark.parametrize("num_splits", [1, 2, 4, 8, None])
def test_paged_kernel_matches_plain(cuda, dtype, case, num_splits):
    b, hq, hkv, hd, bs, nblk, ctx = case
    rng = np.random.default_rng(b * 7 + hq)
    p = nblk * b + 2
    q = _randn(rng, (b, hq, hd), dtype, cuda)
    kp = _randn(rng, (p, bs, hkv, hd), dtype, cuda)
    vp = _randn(rng, (p, bs, hkv, hd), dtype, cuda)
    bt = torch.from_numpy(rng.integers(0, p, (b, nblk)).astype(np.int32)).to(cuda)
    cl = torch.tensor(ctx, dtype=torch.int32, device=cuda)
    got = paged_attention_splitk(q, kp, vp, bt, cl, num_splits=num_splits)
    want = ref.ref_paged_attention(q, kp, vp, bt, cl)
    torch.cuda.synchronize()
    assert got.dtype == dtype and torch.isfinite(got).all()
    live = cl > 0                       # ctx = 0: kernel zeros, plain uniform mean
    assert torch.equal(got[~live], torch.zeros_like(got[~live]))
    tol = DECODE_TOL[dtype]
    torch.testing.assert_close(got[live].float(), want[live].float(), rtol=tol, atol=tol)
    _assert_rel_close(got[live], want[live], dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", CHUNKED_CASES)
def test_chunked_kernel_matches_plain(cuda, dtype, case):
    sc, t, hq, hkv, hd, ctx = case
    rng = np.random.default_rng(sc * 3 + ctx)
    q = _randn(rng, (sc, hq, hd), dtype, cuda)
    k = _randn(rng, (t, hkv, hd), dtype, cuda)
    v = _randn(rng, (t, hkv, hd), dtype, cuda)
    got = chunked_prefill_attention(q, k, v, ctx)
    want = ref.ref_chunked_prefill_attention(q, k, v, ctx)
    torch.cuda.synchronize()
    assert got.shape == q.shape and got.dtype == dtype
    tol = PREFILL_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    _assert_rel_close(got, want, dtype)


@pytest.mark.parametrize("case", CHUNKED_CASES)
def test_chunked_kernel_32_row_tiles_match_plain(cuda, case):
    """bf16 with the tile height not taken by default: 32 packed rows a CTA."""
    sc, t, hq, hkv, hd, ctx = case
    rng = np.random.default_rng(sc * 3 + ctx)
    q, k, v = (_randn(rng, shape, torch.bfloat16, cuda)
               for shape in ((sc, hq, hd), (t, hkv, hd), (t, hkv, hd)))
    got = chunked_prefill_attention(q, k, v, ctx, tile_rows=32)
    want = ref.ref_chunked_prefill_attention(q, k, v, ctx)
    torch.cuda.synchronize()
    assert got.shape == q.shape and got.dtype == torch.bfloat16
    tol = PREFILL_TOL[torch.bfloat16]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    _assert_rel_close(got, want, torch.bfloat16)


def _paged_inputs(case, dtype, dev):
    b, hq, hkv, hd, bs, nblk, ctx = case
    rng = np.random.default_rng(b * 7 + hq)
    p = nblk * b + 2
    q = _randn(rng, (b, hq, hd), dtype, dev)
    kp = _randn(rng, (p, bs, hkv, hd), dtype, dev)
    vp = _randn(rng, (p, bs, hkv, hd), dtype, dev)
    bt = torch.from_numpy(rng.integers(0, p, (b, nblk)).astype(np.int32)).to(dev)
    cl = torch.tensor(ctx, dtype=torch.int32, device=dev)
    return q, kp, vp, bt, cl


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", PAGED_DECODE_CASES)
def test_legacy_paged_kernel_matches_plain(cuda, dtype, case):
    q, kp, vp, bt, cl = _paged_inputs(case, dtype, cuda)
    launches = paged_attention.launches
    got = paged_attention(q, kp, vp, bt, cl)
    want = ref.ref_paged_attention(q, kp, vp, bt, cl)
    torch.cuda.synchronize()
    assert paged_attention.launches == launches + 1
    assert got.dtype == dtype and torch.isfinite(got).all()
    live = cl > 0                       # ctx = 0: kernel zeros, plain uniform mean
    assert torch.equal(got[~live], torch.zeros_like(got[~live]))
    tol = DECODE_TOL[dtype]
    torch.testing.assert_close(got[live].float(), want[live].float(), rtol=tol, atol=tol)
    _assert_rel_close(got[live], want[live], dtype)


def test_legacy_paged_kernel_ignores_garbage_pages(cuda):
    """tests/test_kernels.py's case: pages the table does not reference,
    and table entries past the context, never reach the output."""
    rng = np.random.default_rng(9)
    b, hq, hkv, hd, bs, p = 1, 2, 1, 16, 8, 6
    q = _randn(rng, (b, hq, hd), torch.float32, cuda)
    kp = _randn(rng, (p, bs, hkv, hd), torch.float32, cuda)
    vp = _randn(rng, (p, bs, hkv, hd), torch.float32, cuda)
    bt = torch.tensor([[1, 3]], dtype=torch.int32, device=cuda)
    cl = torch.tensor([12], dtype=torch.int32, device=cuda)
    out1 = paged_attention(q, kp, vp, bt, cl)
    kp2, vp2 = kp.clone(), vp.clone()
    kp2[0], kp2[2], vp2[4] = 999.0, -999.0, 123.0
    out2 = paged_attention(q, kp2, vp2, bt, cl)
    # a table entry past ctx pointing far outside the pool is never read
    bt3 = torch.tensor([[1, 3, 1 << 30]], dtype=torch.int32, device=cuda)
    out3 = paged_attention(q, kp, vp, bt3, cl)
    torch.cuda.synchronize()
    assert torch.equal(out1, out2) and torch.equal(out1, out3)
    torch.testing.assert_close(out1, ref.ref_paged_attention(q, kp, vp, bt, cl),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_mqa_paged_kernels_ignore_garbage_pages(cuda, dtype):
    """At granite-34b's head shape (48 query heads on one kv head, six
    slices): pages the table does not reference, and a table entry past
    the context pointing far outside the pool, change neither kernel's
    output."""
    rng = np.random.default_rng(10)
    b, hq, hkv, hd, bs, p = 2, 48, 1, 128, 16, 12
    q = _randn(rng, (b, hq, hd), dtype, cuda)
    kp = _randn(rng, (p, bs, hkv, hd), dtype, cuda)
    vp = _randn(rng, (p, bs, hkv, hd), dtype, cuda)
    bt = torch.tensor([[1, 3, 5], [7, 9, 11]], dtype=torch.int32, device=cuda)
    cl = torch.tensor([40, 20], dtype=torch.int32, device=cuda)
    kp2, vp2 = kp.clone(), vp.clone()
    kp2[0], kp2[2], vp2[4], kp2[10] = 999.0, -999.0, 123.0, 77.0
    far = torch.tensor([[1, 3, 5], [7, 9, 1 << 30]], dtype=torch.int32, device=cuda)
    for fn in (paged_attention_splitk, paged_attention):
        out1 = fn(q, kp, vp, bt, cl)
        out2 = fn(q, kp2, vp2, bt, cl)
        out3 = fn(q, kp, vp, far, cl)
        torch.cuda.synchronize()
        assert torch.equal(out1, out2) and torch.equal(out1, out3)
        tol = DECODE_TOL[dtype]
        torch.testing.assert_close(out1.float(),
                                   ref.ref_paged_attention(q, kp, vp, bt, cl).float(),
                                   rtol=tol, atol=tol)


def rglru_inputs(rng, b, s, w, dtype, dev, gate):
    """a, b (B,S,W). ``gate``: a as the model's gate makes it,
    exp(-8 softplus(2) r) with r in (0, 1); else sigmoid of a normal draw
    (tests/test_kernels.py's)."""
    if gate:
        r = rng.uniform(0.0, 1.0, (b, s, w))
        a = np.exp(-8.0 * np.log1p(np.exp(2.0)) * r)
    else:
        a = 1.0 / (1.0 + np.exp(-rng.standard_normal((b, s, w))))
    bb = rng.standard_normal((b, s, w))
    return (torch.from_numpy(x.astype(np.float32)).to(dev, dtype) for x in (a, bb))


# (b, s, w, gate, tol): tests/test_kernels.py's sweep, then the hybrid
# path's shapes (W 4096, the prefill lengths of chip_smoke.py); S covers one
# slab (128 steps in float32, 256 in bfloat16), one step either side of a
# slab, ragged last slabs, B 4 at S 3072 and S 8192 (many turns of the
# ring); W 4104 and 4112 leave a ragged last tile of 8 and 16 channels
RGLRU_CASES = [(2, 64, 32, False, 2e-5), (1, 128, 64, False, 2e-5),
               (3, 32, 16, False, 2e-5)]
RGLRU_CASES += [(b, s, 4096, True, 1e-4) for b in (1, 4)
                for s in (1, 37, 128, 2085, 3072)]
RGLRU_CASES += [(1, s, 4096, True, 1e-4) for s in (127, 129, 255, 257, 8192)]
RGLRU_CASES += [(1, 300, w, True, 1e-4) for w in (4104, 4112)]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", RGLRU_CASES)
def test_rglru_kernel_matches_plain(cuda, case, dtype):
    b, s, w, gate, tol = case
    rng = np.random.default_rng(s + w + b)
    a, bb = rglru_inputs(rng, b, s, w, dtype, cuda, gate)
    launches = rglru_scan.launches
    got = rglru_scan(a, bb)
    want = ref.ref_rglru_scan(a, bb)
    torch.cuda.synchronize()
    assert rglru_scan.launches == launches + 1
    assert got.shape == want.shape and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    rel = torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want)
    assert rel < 1e-5, f"relative error {float(rel):.3e}"


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_rglru_kernel_copies_a_misaligned_view(cuda, dtype):
    """a and b as contiguous views that start one element into their
    buffers: the wrapper documents that it copies such an operand to an
    aligned buffer (its 16-byte copies never read it misaligned), so the
    result is the plain version's."""
    b, s, w = 1, 128, 4096
    rng = np.random.default_rng(7)
    a0, b0 = rglru_inputs(rng, b, s, w, dtype, cuda, True)
    a, bb = (torch.cat([x.new_zeros(1), x.flatten()])[1:1 + b * s * w].view(b, s, w)
             for x in (a0, b0))
    assert a.is_contiguous() and a.data_ptr() % 16 != 0
    got = rglru_scan(a, bb)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref.ref_rglru_scan(a0, b0), rtol=1e-4, atol=1e-4)


def _tokens(model, params, device, swap, attn_impl="auto"):
    kw = dict(num_blocks=16, host_kv_blocks=32) if swap else dict(num_blocks=64)
    eng = EchoEngine(model, params, ECHO, block_size=8, chunk_size=16,
                     max_pages_per_seq=16, device=device, attn_impl=attn_impl, **kw)
    rng = np.random.default_rng(2)
    off = Request(prompt=tuple(int(x) for x in rng.integers(0, 128, 56)),
                  max_new_tokens=6, task_type=TaskType.OFFLINE)
    eng.submit(off)
    for _ in range(3):
        eng.step()
    on = Request(prompt=tuple(int(x) for x in rng.integers(0, 128, 88)),
                 max_new_tokens=12, task_type=TaskType.ONLINE,
                 arrival_time=eng.now, slo=SLO(10, 10))
    eng.submit(on)
    eng.run(max_iters=1000)
    assert off.done and on.done
    return [off.output_tokens, on.output_tokens], eng


def test_engine_tokens_on_card_equal_cpu(cuda):
    cfg = ModelConfig(name="tiny-dense", family="dense", source="test",
                      num_layers=2, d_model=64, vocab_size=128, num_heads=4,
                      num_kv_heads=2, head_dim=16, d_ff=128, dtype="float32",
                      rope_theta=10_000.0)
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    gpu_params = tree_map(lambda t: t.to(cuda), params)
    want, _ = _tokens(model, params, "cpu", swap=False)
    launches = paged_attention_splitk.launches, chunked_prefill_attention.launches
    got, _ = _tokens(model, gpu_params, cuda, swap=False)
    assert got == want
    assert paged_attention_splitk.launches > launches[0]
    assert chunked_prefill_attention.launches > launches[1]
    got_swap, eng = _tokens(model, gpu_params, cuda, swap=True)
    assert eng.bm.metrics.swapped_in_tokens > 0
    assert got_swap == want


def test_legacy_engine_tokens_on_card_equal_cpu(cuda):
    """``attn_impl="pallas"``: decode goes through the legacy kernel only."""
    cfg = ModelConfig(name="tiny-dense", family="dense", source="test",
                      num_layers=2, d_model=64, vocab_size=128, num_heads=4,
                      num_kv_heads=2, head_dim=16, d_ff=128, dtype="float32",
                      rope_theta=10_000.0)
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    gpu_params = tree_map(lambda t: t.to(cuda), params)
    want, _ = _tokens(model, params, "cpu", swap=False, attn_impl="pallas")
    launches = paged_attention.launches, paged_attention_splitk.launches
    got, _ = _tokens(model, gpu_params, cuda, swap=False, attn_impl="pallas")
    assert got == want
    assert paged_attention.launches > launches[0]
    assert paged_attention_splitk.launches == launches[1]


@pytest.mark.parametrize("attn_impl", ["auto", "pallas"])
def test_mqa_engine_tokens_on_card_equal_cpu(cuda, attn_impl):
    """A tiny float32 model with 48 query heads on one kv head: the card's
    tokens (six group slices a kv head in each decode kernel) equal the
    CPU's, with and without host-tier swap, under both decode schedules."""
    cfg = ModelConfig(name="tiny-mqa", family="dense", source="test",
                      num_layers=2, d_model=64, vocab_size=128, num_heads=48,
                      num_kv_heads=1, head_dim=16, d_ff=128, dtype="float32",
                      rope_theta=10_000.0)
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    gpu_params = tree_map(lambda t: t.to(cuda), params)
    decode = paged_attention if attn_impl == "pallas" else paged_attention_splitk
    want, _ = _tokens(model, params, "cpu", swap=False, attn_impl=attn_impl)
    launches = decode.launches
    got, _ = _tokens(model, gpu_params, cuda, swap=False, attn_impl=attn_impl)
    assert got == want
    assert decode.launches > launches
    got_swap, eng = _tokens(model, gpu_params, cuda, swap=True, attn_impl=attn_impl)
    assert eng.bm.metrics.swapped_in_tokens > 0
    assert got_swap == want


@pytest.mark.parametrize("cf", [8.0, 0.5])
def test_moe_engine_tokens_on_card_equal_cpu(cuda, cf):
    """qwen3-moe reduced: the tokens of the CPU on the card, with and
    without host-tier swap. At capacity factor 0.5 routing drops tokens,
    so the swap run's batches change its tokens: it is held against the
    CPU's swap run."""
    model = Model(dataclasses.replace(get_config("qwen3-moe-30b-a3b").reduced(),
                                      capacity_factor=cf))
    params = model.init(torch.Generator().manual_seed(0))
    gpu_params = tree_map(lambda t: t.to(cuda), params)
    want, _ = _tokens(model, params, "cpu", swap=False)
    launches = paged_attention_splitk.launches, chunked_prefill_attention.launches
    got, _ = _tokens(model, gpu_params, cuda, swap=False)
    assert got == want
    assert paged_attention_splitk.launches > launches[0]
    assert chunked_prefill_attention.launches > launches[1]
    want_swap, _ = _tokens(model, params, "cpu", swap=True)
    got_swap, eng = _tokens(model, gpu_params, cuda, swap=True)
    assert eng.bm.metrics.swapped_in_tokens > 0
    assert got_swap == want_swap
    if cf >= 1:
        assert got_swap == want


@pytest.mark.parametrize("rows", [(1, 64), (8, 1)], ids=["chunk", "decode"])
def test_moe_layer_on_card_matches_cpu(cuda, rows):
    """One float32 MoE layer (d 1024, 64 experts of d_ff 256, top-8,
    capacity 1.25): the card routes exactly as the CPU, on inputs whose
    top-9 gates (the ones the eight choices compare) keep 1e-6 apart, and
    the outputs agree to 1e-4 relative."""
    from repro_torch.models import moe
    cfg = dataclasses.replace(get_config("qwen3-moe-30b-a3b"), d_model=1024,
                              num_experts=64, d_ff=256, dtype="float32")
    p = moe.moe_init(torch.Generator().manual_seed(0), cfg, torch.float32)
    x = torch.randn(rows + (cfg.d_model,), generator=torch.Generator().manual_seed(1))
    gates = torch.softmax(x.reshape(-1, cfg.d_model).double() @ p["router"].double(), -1)
    top = gates.sort(-1, descending=True).values[:, :cfg.top_k + 1]
    assert float((top[:, :-1] - top[:, 1:]).min()) > 1e-6
    gp = tree_map(lambda t: t.to(cuda), p)
    t = rows[0] * rows[1]
    cap = max(int(np.ceil(t * cfg.capacity_factor * cfg.top_k / cfg.num_experts)), 1)
    routes = [moe._route(torch.softmax(xx.reshape(1, t, -1) @ pp["router"], -1),
                         cfg.top_k, cap)
              for xx, pp in ((x, p), (x.to(cuda), gp))]
    assert torch.equal(routes[1][0].cpu(), routes[0][0])
    want = moe.moe_apply(p, cfg, x)
    got = moe.moe_apply(gp, cfg, x.to(cuda)).cpu()
    rel = torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want)
    assert rel < 1e-4, float(rel)


def ssd_inputs(rng, case, dev, slow=False, with_init=False):
    """x, dt_a, B, C and an optional initial state; ``slow`` makes dt_a
    about -0.01 softplus(.), so the carried and initial state dominate y."""
    b, s, h, p, n, _ = case
    x = _randn(rng, (b, s, h, p), torch.float32, dev)
    dta = -(0.01 if slow else 1.0) * torch.nn.functional.softplus(
        _randn(rng, (b, s, h), torch.float32, dev))
    bm = _randn(rng, (b, s, n), torch.float32, dev)
    cm = _randn(rng, (b, s, n), torch.float32, dev)
    init = _randn(rng, (b, h, p, n), torch.float32, dev) if with_init else None
    return x, dta, bm, cm, init


@pytest.mark.parametrize("slow", [False, True], ids=["decay", "slow-decay"])
@pytest.mark.parametrize("with_init", [False, True], ids=["zero-init", "init"])
@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_kernel_matches_plain(cuda, case, with_init, slow):
    rng = np.random.default_rng(case[1] + case[3] + 2 * with_init + slow)
    x, dta, bm, cm, init = ssd_inputs(rng, case, cuda, slow, with_init)
    chunk = case[-1]
    launches = ssd_scan.launches
    got = ssd_scan(x, dta, bm, cm, chunk=chunk, initial_state=init,
                   return_all_states=True)
    want = ssd_chunked(x, dta, bm, cm, chunk, initial_state=init,
                       return_all_states=True)
    torch.cuda.synchronize()
    assert ssd_scan.launches == launches + 1
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g, w, rtol=2e-4, atol=2e-4)
        _assert_rel_close(g, w, torch.float32)
    y, fs = ssd_scan(x, dta, bm, cm, chunk=chunk, initial_state=init)
    assert torch.equal(y, got[0]) and torch.equal(fs, got[1])


def tiny_mamba2():
    return ModelConfig(name="tiny-mamba2", family="ssm", source="test",
                       num_layers=2, d_model=64, vocab_size=128, ssm_state=16,
                       ssm_head_dim=16, ssm_chunk=16, tie_embeddings=True,
                       dtype="float32")


def _state_tokens(model, params, device, swap):
    """tests/test_state_tiering.py's workload on a tight pool: a shared
    document, pooled questions and an online burst."""
    bs = model.cfg.ssm_chunk
    eng = EchoEngine(model, params, ECHO, num_blocks=8, block_size=bs,
                     chunk_size=2 * bs, max_pages_per_seq=16, max_running=2,
                     host_kv_blocks=32 if swap else 0, device=device)
    rng = np.random.default_rng(3)
    vocab = model.cfg.vocab_size

    def toks(n):
        return tuple(int(x) for x in rng.integers(0, vocab, n))
    doc = toks(3 * bs)
    reqs = [Request(prompt=doc + toks(7), max_new_tokens=4,
                    task_type=TaskType.OFFLINE) for _ in range(6)]
    reqs += [Request(prompt=toks(3 * bs), max_new_tokens=4, task_type=TaskType.ONLINE,
                     arrival_time=0.0004 * (i + 1), slo=SLO(30.0, 5.0))
             for i in range(3)]
    for r in reqs:
        eng.submit(r)
    eng.run(max_iters=2000)
    assert all(r.done for r in reqs)
    return [r.output_tokens for r in reqs], eng


def test_state_engine_tokens_on_card_equal_cpu(cuda):
    model = Model(tiny_mamba2())
    params = model.init(torch.Generator().manual_seed(0))
    gpu_params = tree_map(lambda t: t.to(cuda), params)
    want, _ = _state_tokens(model, params, "cpu", swap=False)
    launches, plain = ssd_scan.launches, ssd_chunked.cuda_calls
    got, eng = _state_tokens(model, gpu_params, cuda, swap=False)
    assert got == want
    assert ssd_scan.launches - launches == 2 * eng.runner.span_calls > 0
    assert ssd_chunked.cuda_calls == plain
    assert eng.bm.metrics.hit_blocks > 0
    got_swap, eng = _state_tokens(model, gpu_params, cuda, swap=True)
    assert eng.bm.metrics.swapped_out_tokens > 0
    assert eng.bm.metrics.swapped_in_tokens > 0
    assert got_swap == want


def tiny_hybrid():
    """recurrentgemma reduced to 5 layers with a window of 8: one scanned
    (rglru, rglru, attn) unit and the unrolled (rglru, rglru)."""
    return dataclasses.replace(get_config("recurrentgemma-9b").reduced(),
                               num_layers=5, window=8)


def test_hybrid_engine_tokens_on_card_equal_cpu(cuda):
    """The hybrid state engine (token by token through decode_step) gives
    the CPU's tokens on the card, and the card's dense path (prefill with
    the RG-LRU kernel, pad_cache onto the ring, decode_step) gives them
    too."""
    model = Model(tiny_hybrid())
    params = model.init(torch.Generator().manual_seed(0))
    gpu_params = tree_map(lambda t: t.to(cuda), params)
    vocab = model.cfg.vocab_size
    rng = np.random.default_rng(4)
    doc = tuple(int(x) for x in rng.integers(0, vocab, 32))
    prompts = [doc + tuple(int(x) for x in rng.integers(0, vocab, 7))
               for _ in range(2)]

    def serve(p, device):
        eng = EchoEngine(model, p, ECHO, num_blocks=64, block_size=16,
                         chunk_size=16, max_pages_per_seq=16, device=device)
        reqs = [Request(prompt=pr, max_new_tokens=4, task_type=TaskType.OFFLINE)
                for pr in prompts]
        for r in reqs:
            eng.submit(r)
        eng.run(max_iters=1000)
        assert all(r.done for r in reqs) and eng.bm.metrics.hit_blocks > 0
        return [r.output_tokens for r in reqs]
    want = serve(params, "cpu")
    assert serve(gpu_params, cuda) == want

    launches, plain = rglru_scan.launches, ref.ref_rglru_scan.cuda_calls
    dense = []
    with torch.inference_mode():
        for pr in prompts:
            last, cache = model.prefill(gpu_params, torch.tensor([pr], device=cuda))
            cache = model.pad_cache(cache, len(pr), len(pr) + 5)
            out = [int(torch.argmax(last[0]))]
            for pos in range(len(pr), len(pr) + 3):
                lg, cache = model.decode_step(
                    gpu_params, torch.tensor([out[-1]], device=cuda), cache,
                    torch.tensor([pos], device=cuda))
                out.append(int(torch.argmax(lg[0])))
            dense.append(out)
    assert dense == want
    assert rglru_scan.launches - launches == 4 * len(prompts)
    assert ref.ref_rglru_scan.cuda_calls == plain


def test_prefix_migration_between_two_runners_on_card(cuda):
    """Two engines on the card, each with its own ``TorchPagedRunner`` pool
    and host tier, sharing one copy of the weights (musicgen-medium
    reduced, in bf16): the document's pages leave replica 0 for replica 1's
    host tier, replica 1 restores them instead of recomputing, and its
    greedy tokens equal replica 0's (the runs are serial, so every kernel
    and product has the same shape)."""
    cfg = dataclasses.replace(get_config("musicgen-medium").reduced(), dtype="bfloat16")
    model = Model(cfg)
    params = tree_map(lambda t: t.to(cuda), model.init(torch.Generator().manual_seed(0)))

    def replica(i):
        return Replica(i, EchoEngine(model, params, ECHO, num_blocks=32, block_size=8,
                                     chunk_size=16, max_pages_per_seq=16,
                                     host_kv_blocks=32, device=cuda))
    rep0, rep1 = replica(0), replica(1)
    router = Router([rep0, rep1])
    rng = np.random.default_rng(5)
    doc = tuple(int(x) for x in rng.integers(0, cfg.vocab_size, 48))    # 6 blocks
    q = tuple(int(x) for x in rng.integers(0, cfg.vocab_size, 5))

    def offline(prompt, n):
        return Request(prompt=prompt, max_new_tokens=n, task_type=TaskType.OFFLINE)
    rep0.submit(offline(doc, 2))
    rep0.engine.run(max_iters=200)
    local = offline(doc + q, 8)
    rep0.submit(local)
    rep0.engine.run(max_iters=200)
    moved = offline(doc + q, 8)
    launches = paged_attention_splitk.launches, chunked_prefill_attention.launches
    admitted = router.migrate_prefix(rep0, rep1, moved)
    assert admitted == router.stats.migrated_bytes > 0
    assert rep1.engine.bm.metrics.migrated_in_blocks == router.stats.migrated_blocks == 6
    rep1.submit(moved)
    rep1.engine.run(max_iters=200)
    assert local.done and moved.done
    assert rep1.engine.bm.metrics.swapped_in_tokens > 0
    assert moved.output_tokens == local.output_tokens
    assert paged_attention_splitk.launches > launches[0]
    assert chunked_prefill_attention.launches > launches[1]
    snap = rep1.engine.bm.occupancy_snapshot()
    assert snap["running"] == 0


def test_calibrate_link_applies_on_card(cuda):
    """The link calibration measures the card's pageable copies and fits."""
    from repro_torch.core import TimeModel
    from repro_torch.rt import calibrate_link
    from repro_torch.rt.calibrate import DEFAULT_SIZES
    tm = TimeModel.h100()
    cal = calibrate_link(tm, device=cuda)
    assert cal.applied and cal.error is None
    assert cal.backend == torch.cuda.get_device_name(cuda)
    assert tm.swap_byte == cal.swap_byte > 0.0
    assert 0.5 < cal.bandwidth_gbs < 100.0
    # the fastest copy of each size up and down; two overlapped uploads a size
    assert [n for n, _ in cal.samples] == [n for n in DEFAULT_SIZES for _ in range(2)]
    assert len(cal.overlap_samples) == 2 * len(DEFAULT_SIZES)


def test_front_door_tokens_on_card_equal_cpu(cuda):
    """A tiny float32 model through ``AsyncEchoEngine`` on a paused
    ``ManualClock``: the card's tokens and finish times equal the CPU's,
    through the kernels."""
    import asyncio
    from repro_torch.rt import AsyncEchoEngine, ManualClock
    cfg = ModelConfig(name="tiny-dense", family="dense", source="test",
                      num_layers=2, d_model=64, vocab_size=128, num_heads=4,
                      num_kv_heads=2, head_dim=16, d_ff=128, dtype="float32",
                      rope_theta=10_000.0)
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(3)
    specs = [(tuple(int(x) for x in rng.integers(0, 128, n)), task, at)
             for n, task, at in ((40, TaskType.ONLINE, 0.0), (96, TaskType.ONLINE, 0.05),
                                 (56, TaskType.OFFLINE, 0.0), (56, TaskType.OFFLINE, 0.0))]

    def serve(device, weights):
        eng = EchoEngine(model, weights, ECHO, num_blocks=64, block_size=8, chunk_size=16,
                         max_pages_per_seq=16, device=device)
        reqs = [Request(prompt=p, max_new_tokens=8, task_type=task, arrival_time=at,
                        slo=SLO(10, 10) if task is TaskType.ONLINE else None)
                for p, task, at in specs]

        async def main():
            rt = AsyncEchoEngine(eng, clock=ManualClock())
            async with rt:
                hs = [await rt.submit_request(r) for r in reqs]
                results = [await h.result() for h in hs]
            assert not any(rt.kv_leaks().values())
            return [(r.status.value, r.tokens, r.finish_time) for r in results]
        return asyncio.run(main())

    want = serve("cpu", params)
    launches = paged_attention_splitk.launches, chunked_prefill_attention.launches
    got = serve(cuda, tree_map(lambda t: t.to(cuda), params))
    assert got == want
    assert all(status == "finished" for status, _, _ in got)
    assert paged_attention_splitk.launches > launches[0]
    assert chunked_prefill_attention.launches > launches[1]


# ------------------------------------------------------------ training
# (b, s, w, dtype): recurrentgemma's training shape (S 4096, W 4096), a
# partial last slab (S 4000), short S, a ragged last channel tile, and a
# from bf16 (the kernel writes da and db in a's type)
RGLRU_BWD_CASES = [(1, 4096, 4096, torch.float32), (1, 4000, 4096, torch.float32),
                   (2, 300, 4096, torch.float32), (1, 37, 4096, torch.float32),
                   (1, 300, 4104, torch.float32), (1, 300, 4096, torch.bfloat16)]


@pytest.mark.parametrize("case", RGLRU_BWD_CASES, ids=str)
def test_rglru_backward_kernel_matches_plain(cuda, case):
    from repro_torch.kernels import rglru_scan as rglru_mod
    b, s, w, dtype = case
    rng = np.random.default_rng(s + w + b)
    a, bb = rglru_inputs(rng, b, s, w, dtype, cuda, True)
    h = rglru_scan(a, bb)
    g = _randn(rng, (b, s, w), torch.float32, cuda)
    launches = rglru_mod.rglru_scan_bwd.launches
    got = rglru_mod.rglru_scan_bwd(a, h, g)
    want = ref.ref_rglru_scan_bwd(a, h, g)
    torch.cuda.synchronize()
    assert rglru_mod.rglru_scan_bwd.launches == launches + 1
    for x, y in zip(got, want):
        assert x.shape == y.shape and x.dtype == dtype and torch.isfinite(x).all()
        _assert_rel_close(x, y, dtype)
        if dtype == torch.float32:
            torch.testing.assert_close(x, y, rtol=0, atol=1e-5 * float(y.abs().max()))


# the backward's cases: the forward's, and 12 heads (a short last head group)
SSD_BWD_CASES = SSD_CASES + [(1, 128, 12, 64, 128, 64)]


@pytest.mark.parametrize("slow", [False, True], ids=["decay", "slow-decay"])
@pytest.mark.parametrize("pad", [0, 11], ids=["whole", "padded"])
@pytest.mark.parametrize("case", SSD_BWD_CASES)
def test_ssd_backward_kernel_matches_plain(cuda, case, pad, slow):
    """The four gradients of the SSD backward kernel against its plain
    backward from a zero state; "padded": the last 11 steps as the model
    pads a sequence (dt 0, zero x, B, C, and no cotangent). A second call on
    the same inputs gives bitwise-equal gradients (every sum of the three
    launches runs in a fixed order)."""
    from repro_torch.kernels import ssd_scan as ssd_mod
    rng = np.random.default_rng(case[1] + case[3] + pad + slow)
    x, dta, bm, cm, _ = ssd_inputs(rng, case, cuda, slow)
    s, chunk = case[1], case[-1]
    for t in (x, dta, bm, cm):
        t[:, s - pad:] = 0.0
    y, final, states = ssd_scan(x, dta, bm, cm, chunk=chunk, return_all_states=True)
    dy, dfinal = torch.randn_like(y), torch.randn_like(final)
    dy[:, s - pad:] = 0.0
    launches = ssd_mod.ssd_scan_bwd.launches
    got = ssd_mod.ssd_scan_bwd(x, dta, bm, cm, chunk, states, dy, dfinal)
    again = ssd_mod.ssd_scan_bwd(x, dta, bm, cm, chunk, states, dy, dfinal)
    want = ssd_mod.ssd_chunked_bwd(x, dta, bm, cm, chunk, states, dy, dfinal)
    torch.cuda.synchronize()
    assert ssd_mod.ssd_scan_bwd.launches == launches + 2
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32 and torch.isfinite(g).all()
        torch.testing.assert_close(g, w, rtol=0, atol=1e-5 * float(w.abs().max()))
        rel = torch.linalg.vector_norm(g - w) / torch.linalg.vector_norm(w)
        assert rel < 1e-5, f"relative error {float(rel):.3e}"


def test_scan_functions_on_card_match_autograd_of_plain(cuda):
    """With a gradient wanted, ``ops`` runs each scan's Function (kernel
    forward and backward) on the card: the gradients equal
    ``torch.autograd.grad`` of the plain forward on the same inputs."""
    from repro_torch.kernels import ops
    rng = np.random.default_rng(11)
    a, bb = rglru_inputs(rng, 2, 300, 4096, torch.float32, cuda, True)
    a.requires_grad_()
    bb.requires_grad_()
    g = torch.randn_like(a)
    got = torch.autograd.grad(ops.rglru_scan(a, bb), (a, bb), g)
    want = torch.autograd.grad(ref.ref_rglru_scan(a, bb), (a, bb), g)
    for x, y in zip(got, want):
        _assert_rel_close(x, y, torch.float32)
    x, dta, bm, cm, _ = ssd_inputs(rng, (1, 256, 8, 64, 128, 64), cuda)
    ins = [t.requires_grad_() for t in (x, dta, bm, cm)]
    y, final = ops.ssd_scan(*ins, chunk=64)
    dy, dfinal = torch.randn_like(y), torch.randn_like(final)
    got = torch.autograd.grad((y, final), ins, (dy, dfinal))
    y, final = ssd_chunked(*ins, 64)
    want = torch.autograd.grad((y, final), ins, (dy, dfinal))
    for x, y in zip(got, want):
        _assert_rel_close(x, y, torch.float32)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "recurrentgemma-9b"])
def test_train_step_on_card_equals_cpu(cuda, arch):
    """The loss and gradients of one training step of the reduced float32
    config: the loss to 1e-5 relative, every gradient to rtol 1e-4 / atol
    1e-6, with the scans' backward kernels launched on the card."""
    from repro_torch.kernels import rglru_scan as rglru_mod
    from repro_torch.kernels import ssd_scan as ssd_mod
    from repro_torch.training.data import TokenStream
    from repro_torch.training.train_step import loss_and_grads
    cfg = get_config(arch).reduced()
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    batch = next(TokenStream(cfg.vocab_size, seed=0).batches(2, 32))
    kernels = (ssd_mod.ssd_scan_bwd, rglru_mod.rglru_scan_bwd)
    before = [k.launches for k in kernels]
    out = {}
    for dev, p in (("cpu", params), (cuda, tree_map(lambda t: t.to(cuda), params))):
        out[str(dev)] = loss_and_grads(
            model, p, {k: torch.as_tensor(v).to(dev) for k, v in batch.items()})
    (loss_c, grads_c), (loss_g, grads_g) = out["cpu"], out["cuda"]
    assert float(loss_g) == pytest.approx(float(loss_c), rel=1e-5)
    for gc, gg in zip(grads_c, grads_g):
        torch.testing.assert_close(gg.cpu(), gc, rtol=1e-4, atol=1e-6)
    assert sum(k.launches for k in kernels) > sum(before)
