"""Card-only tests of the port: each CUDA kernel against its plain PyTorch
version on the card, on the cases of tests/test_kernels.py and at the main
path's shapes, and the engine's tokens on the card against the CPU.

They skip without a CUDA device. This file imports no jax, so it also runs
where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.core import ECHO, SLO, EchoEngine, Request, TaskType  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.chunked_prefill import chunked_prefill_attention  # noqa: E402
from repro_torch.kernels.paged_attention import paged_attention_splitk  # noqa: E402
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
]
CHUNKED_CASES = [
    (64, 128, 4, 2, 32, 0), (64, 128, 4, 2, 32, 37), (32, 64, 2, 1, 64, 30),
    (100, 420, 4, 1, 32, 250), (65, 131, 8, 2, 32, 66), (7, 16, 4, 4, 16, 9),
    (64, 192, 8, 8, 32, 128),
    (64, 512, 32, 8, 128, 0), (64, 512, 32, 8, 128, 448),           # qwen3-4b
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
@pytest.mark.parametrize("num_splits", [1, 2, 4, None])
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


def _tokens(model, params, device, swap):
    kw = dict(num_blocks=16, host_kv_blocks=32) if swap else dict(num_blocks=64)
    eng = EchoEngine(model, params, ECHO, block_size=8, chunk_size=16,
                     max_pages_per_seq=16, device=device, **kw)
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
