"""Query groups past 8: the port's attention at G 5 (llama4-scout's 40
query heads on 8 kv heads), G 9 and G 12 (a short last slice of 8 rows)
and G 48 (granite-34b's MQA, 48 query heads on one kv head).

The plain decode and prefill versions against the reference's Pallas
kernels in interpret mode (both decode schedules, split-K at 1, 2 and 4
pages a split) and its oracles, at the tolerances of tests/test_kernels.py;
the split count and the wrappers' checks and launch at these groups; and
the paged runner's logits and the engine's greedy tokens against the JAX
package on reduced granite-34b with its MQA group kept."""
import dataclasses
import warnings
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.chunked_prefill import chunked_prefill_attention as pallas_chunked  # noqa: E402
from repro.kernels.paged_attention import paged_attention as pallas_legacy  # noqa: E402
from repro.kernels.paged_attention import paged_attention_splitk as pallas_splitk  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.models.paged import PagedRunner  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels import chunked_prefill as cp_mod  # noqa: E402
from repro_torch.kernels import paged_attention as pa_mod  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.paged import TorchPagedRunner  # noqa: E402
from repro_torch.params import from_jax  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
DECODE_TOL = {"float32": 2e-4, "bfloat16": 2e-2}
PREFILL_TOL = {"float32": 2e-4, "bfloat16": 3e-2}

# (b, hq, hkv, hd, bs, nblk, ctx_lens): ragged rows, one under a page, one
# at ctx 0 (a padded row: the plain version gives the uniform mean there,
# the reference's kernels and the port's give zeros; the engine reads none)
MQA_DECODE_CASES = [
    pytest.param((3, 10, 2, 16, 8, 5, [33, 5, 0]), id="G5"),
    pytest.param((2, 9, 1, 32, 8, 4, [30, 3]), id="G9"),
    pytest.param((3, 12, 1, 16, 4, 6, [24, 2, 0]), id="G12"),
    pytest.param((3, 48, 1, 32, 16, 6, [5, 70, 96]), id="G48"),
    pytest.param((3, 48, 1, 16, 8, 4, [0, 29, 7]), id="G48-ctx0"),
]
# (sc, t, hq, hkv, hd, ctx, blk_q, blk_k): at G 48 one query position is 48
# packed rows, so the kernel's 64-row tiles straddle positions
MQA_CHUNKED_CASES = [
    pytest.param((16, 64, 10, 2, 16, 20, 16, 32), id="G5"),
    pytest.param((13, 40, 9, 1, 32, 11, 16, 16), id="G9"),
    pytest.param((24, 80, 12, 1, 16, 0, 16, 32), id="G12"),
    pytest.param((32, 128, 48, 1, 32, 37, 32, 32), id="G48"),
    pytest.param((7, 40, 48, 1, 16, 33, 16, 16), id="G48-short"),
]


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


def _assert_live_rows_close(got, want, ctx_lens, tol):
    live = np.asarray(ctx_lens) > 0
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(_f32(got)[live], _f32(want)[live], rtol=tol, atol=tol)


# ---------------------------------------------------------------- decode
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", MQA_DECODE_CASES)
def test_mqa_paged_plain_matches_jax_oracle(dtype, case):
    b, hq, hkv, hd, bs, nblk, ctx_lens = case
    jin, tin = _paged_inputs(b * 7 + hq, *case, dtype)
    got = ref.ref_paged_attention(*tin)
    assert got.shape == (b, hq, hd) and got.dtype == tin[0].dtype
    np.testing.assert_allclose(_f32(got), _f32(jref.ref_paged_attention(*jin)),
                               rtol=DECODE_TOL[dtype], atol=DECODE_TOL[dtype])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", MQA_DECODE_CASES)
@pytest.mark.parametrize("schedule", ["splitk-1", "splitk-2", "splitk-4", "legacy"])
def test_mqa_paged_plain_matches_pallas(dtype, case, schedule):
    """Both wrappers on CPU tensors (their plain version) against the
    reference's decode kernels in interpret mode: split-K at 1, 2 and 4
    pages a split, and the legacy serial-page schedule."""
    jin, tin = _paged_inputs(case[0] * 7 + case[1], *case, dtype)
    if schedule == "legacy":
        got = pa_mod.paged_attention(*tin)
        want = pallas_legacy(*jin, interpret=True)
    else:
        got = pa_mod.paged_attention_splitk(*tin)
        want = pallas_splitk(*jin, pages_per_split=int(schedule[-1]), interpret=True)
    _assert_live_rows_close(got, want, case[6], DECODE_TOL[dtype])


# ---------------------------------------------------------------- prefill
def _chunked_inputs(seed, sc, t, hq, hkv, hd, dtype):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape, np.float32)
            for shape in ((sc, hq, hd), (t, hkv, hd), (t, hkv, hd))]
    pairs = [_both(a, dtype) for a in arrs]
    return tuple(j for j, _ in pairs), tuple(t_ for _, t_ in pairs)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", MQA_CHUNKED_CASES)
def test_mqa_chunked_plain_matches_pallas_and_oracle(dtype, case):
    sc, t, hq, hkv, hd, ctx, blk_q, blk_k = case
    jin, tin = _chunked_inputs(sc * 3 + ctx + hq, sc, t, hq, hkv, hd, dtype)
    got = cp_mod.chunked_prefill_attention(*tin, ctx)
    assert got.shape == (sc, hq, hd) and got.dtype == tin[0].dtype
    tol = PREFILL_TOL[dtype]
    np.testing.assert_allclose(
        _f32(got), _f32(pallas_chunked(*jin, ctx, blk_q=blk_q, blk_k=blk_k,
                                       interpret=True)), rtol=tol, atol=tol)
    np.testing.assert_allclose(_f32(got), _f32(jref.ref_chunked_prefill_attention(*jin, ctx)),
                               rtol=tol, atol=tol)


# ---------------------------------------------------------------- launch
@pytest.mark.parametrize("group,slices", [(1, 1), (4, 1), (5, 1), (8, 1), (9, 2),
                                          (12, 2), (16, 2), (17, 3), (48, 6)])
def test_group_slices(group, slices):
    assert pa_mod.group_slices(group) == slices


@pytest.mark.parametrize("b,hkv,nblk,bs,group,want", [
    (8, 1, 32, 16, 48, 1),      # granite's serve: 32 tiles, one split
    (2, 1, 512, 16, 48, 8),     # granite at long context: a full cluster
    (64, 1, 512, 16, 48, 2),    # 384 CTAs a split: two waves of 4 a SM allow 2
    (64, 1, 512, 16, 8, 8),     # the same rows at G 8: one slice, 8 splits
    (32, 8, 512, 16, 5, 4),     # llama4-scout's G 5: one slice, 256 CTAs a split
    (32, 8, 512, 16, 9, 2),     # G 9: two slices, 512 CTAs a split
])
def test_default_split_counts_group_slices(b, hkv, nblk, bs, group, want):
    assert pa_mod.default_num_splits(b, hkv, nblk, bs, 132, group) == want


@pytest.mark.parametrize("b,hkv,nblk,bs", [(8, 8, 32, 16), (2, 8, 512, 16),
                                           (64, 8, 512, 16), (1, 1, 4096, 16)])
def test_default_split_unchanged_up_to_g8(b, hkv, nblk, bs):
    """A group of up to 8 is one slice: the split count is the one the
    kernel has always been given."""
    want = pa_mod.default_num_splits(b, hkv, nblk, bs, 132)
    for group in (1, 4, 8):
        assert pa_mod.default_num_splits(b, hkv, nblk, bs, 132, group) == want


def _decode_tensors(b, hq, hkv, hd=32, bs=8, nblk=4, device="cpu"):
    q = torch.zeros((b, hq, hd), device=device)
    kp = torch.zeros((b * nblk, bs, hkv, hd), device=device)
    bt = torch.zeros((b, nblk), dtype=torch.int32, device=device)
    cl = torch.ones((b,), dtype=torch.int32, device=device)
    return q, kp, kp.clone(), bt, cl


@pytest.mark.parametrize("hq,hkv", [(48, 1), (40, 8), (9, 1), (12, 1), (96, 2)])
def test_decode_check_takes_any_group(hq, hkv):
    pa_mod._check(*_decode_tensors(2, hq, hkv))


@pytest.mark.parametrize("hq,hkv", [(48, 5), (10, 4), (9, 2)])
def test_decode_check_rejects_uneven_groups(hq, hkv):
    with pytest.raises(ValueError, match="head shapes disagree"):
        pa_mod._check(*_decode_tensors(2, hq, hkv))


@pytest.fixture
def fake_launch(monkeypatch):
    """CUDA tensors without a card (fake tensors carry the device, no
    storage) and a stand-in for each kernel's C entry that records the
    integers between its six pointers and its stream; the plain versions
    are tripwires."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    calls = []

    def kernel_fn(lib, name, argtypes):
        def launch(*args):
            calls.append((name, list(args[6:-1])))
            return 0
        return launch

    def trip(*a, **k):
        raise AssertionError("plain version called for a CUDA tensor")
    monkeypatch.setattr(build, "kernel_fn", kernel_fn)
    monkeypatch.setattr(pa_mod, "ref_paged_attention", trip)
    monkeypatch.setattr(pa_mod, "_num_sms", lambda index: 132)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=0))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")       # data_ptr() of a fake tensor
        with FakeTensorMode():
            yield calls


@pytest.mark.parametrize("b,hq,hkv,nblk", [(8, 48, 1, 32), (2, 48, 1, 512),
                                           (4, 40, 8, 32), (3, 12, 1, 4)])
def test_decode_wrappers_launch_at_any_group(fake_launch, b, hq, hkv, nblk):
    """On CUDA tensors both decode wrappers launch their kernel once at
    G 48, 5 and 12, with the shape and split count the grid is built
    from, and count the launch."""
    ins = _decode_tensors(b, hq, hkv, hd=128, bs=16, nblk=nblk, device="cuda")
    before = (pa_mod.paged_attention_splitk.launches, pa_mod.paged_attention.launches)
    out = pa_mod.paged_attention_splitk(*ins)
    assert out.shape == (b, hq, 128) and out.device.type == "cuda"
    pa_mod.paged_attention(*ins)
    splits = pa_mod.default_num_splits(b, hkv, nblk, 16, 132, hq // hkv)
    assert fake_launch == [
        ("paged_attention_splitk", [b, hq, hkv, 128, 16, nblk, splits, 0]),
        ("paged_attention", [b, hq, hkv, 128, 16, nblk, 0])]
    assert (pa_mod.paged_attention_splitk.launches, pa_mod.paged_attention.launches) \
        == (before[0] + 1, before[1] + 1)


# ---------------------------------------------------------------- runner, engine
def _granite_mqa():
    """Reduced granite-34b with its MQA group kept: 48 query heads of 32
    on one kv head (reduced() caps the heads at 4)."""
    return dataclasses.replace(jget_config("granite-34b").reduced(),
                               num_heads=48, num_kv_heads=1)


@pytest.fixture(scope="module")
def granite():
    jcfg = _granite_mqa()
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(ModelConfig(**dataclasses.asdict(jcfg)))
    return (jm, jp), (tm, from_jax(jax.tree.map(np.asarray, jp), "cpu"))


@pytest.mark.parametrize("impl", ["ref", "splitk", "pallas"])
def test_granite_mqa_runner_logits_match(granite, impl):
    """TorchPagedRunner's prefill and decode logits (float32) against the
    JAX PagedRunner's, at 1e-4: its plain attention ("ref"), and its
    split-K and legacy Pallas kernels in interpret mode against the
    port's schedule of the same name."""
    (jm, jp), (tm, tp) = granite
    assert tm.cfg.num_heads // tm.cfg.num_kv_heads == 48
    kw = dict(num_pages=16, page_size=8, max_pages_per_seq=8, chunk_size=16)
    jr = PagedRunner(jm, jp, attn_impl=impl, **kw)
    tr = TorchPagedRunner(tm, tp, device="cpu",
                          attn_impl="pallas" if impl == "pallas" else "auto", **kw)
    rng = np.random.default_rng(4)
    vocab = jm.cfg.vocab_size
    a = [int(x) for x in rng.integers(0, vocab, 21)]
    b = [int(x) for x in rng.integers(0, vocab, 9)]
    steps = [("prefill_chunk", (a[:16], 0, [3, 5, 7])),
             ("prefill_chunk", (a[16:], 16, [3, 5, 7])),
             ("prefill_chunk", (b, 0, [9, 2])),
             ("decode", ([5, 7], [[3, 5, 7], [9, 2]], [21, 9])),
             ("decode", ([1, 2, 3], [[3, 5, 7], [9, 2], [11]], [22, 10, 0]))]
    for method, args in steps:
        got = getattr(tr, method)(*args)
        want = np.asarray(getattr(jr, method)(*args), np.float32)
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def _serve(core, model, params, specs, **eng_kw):
    reqs = [core.Request(prompt=p, max_new_tokens=n,
                         task_type=getattr(core.TaskType, task), arrival_time=arr,
                         slo=core.SLO(*slo) if slo else None)
            for p, n, task, arr, slo in specs]
    eng = core.EchoEngine(model, params, core.ECHO, **eng_kw)
    for r in reqs:
        eng.submit(r)
    eng.run(max_iters=1000)
    assert all(r.done for r in reqs)
    return eng, reqs


@pytest.mark.parametrize("attn_impl", ["auto", "pallas"])
def test_granite_mqa_engine_tokens_match_jax(granite, attn_impl):
    """EchoEngine's greedy tokens on reduced granite with G 48 equal the
    JAX engine's (float32; exact equality of the argmax), with a shared
    prefix and a preemption: under "auto" both engines run their plain
    attention on the CPU, under "pallas" JAX runs its legacy Pallas decode
    kernel in interpret mode."""
    (jm, jp), (tm, tp) = granite
    rng = np.random.default_rng(7)
    vocab = jm.cfg.vocab_size

    def prompt(n):
        return tuple(int(x) for x in rng.integers(0, vocab, n))
    doc = prompt(24)
    specs = [(doc + prompt(8), 5, "OFFLINE", 0.0, None) for _ in range(2)]
    specs.append((prompt(40), 5, "ONLINE", 0.002, (10, 10)))
    kw = dict(num_blocks=14, block_size=8, chunk_size=16, max_pages_per_seq=16,
              attn_impl=attn_impl)
    _, jreqs = _serve(jcore, jm, jp, specs, **kw)
    teng, treqs = _serve(tcore, tm, tp, specs, device="cpu", **kw)
    assert [r.output_tokens for r in treqs] == [r.output_tokens for r in jreqs]
    assert [r.n_preemptions for r in treqs] == [r.n_preemptions for r in jreqs]
    assert teng.bm.metrics.hit_blocks > 0
