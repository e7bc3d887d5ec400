"""The port's RG-LRU scan (plain version), RG-LRU and windowed-attention
layers and the hybrid model's dense path against the JAX package: the
Pallas ``rglru_scan`` in interpret mode and the sequential oracle on the
cases of tests/test_kernels.py; ``rglru_context`` / ``rglru_decode``,
``attn_context`` (both branches, window and padding masks) / ``attn_decode``
across a ring wrap, ``Model.prefill`` / ``pad_cache`` / ``decode_step`` on
recurrentgemma reduced (an empty scan segment) and on a 5-layer, window-8
variant with the full width's structure (one scan unit, the unrolled
remainder); and the full-width state sizes. Inputs come from numpy with a
seed, parameters from the JAX init through ``from_jax``. Tolerances:
float32; 2e-5 for the scan (the JAX sweep's), 2e-4 for layers and models,
whose sums run in other orders."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core.block_io import io_spec_for_model as jio_spec  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.rglru_scan import rglru_scan as pallas_rglru  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import rglru as jrglru  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.core.block_io import io_spec_for_model  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import rglru_scan as rglru_kernel  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import rglru  # noqa: E402
from repro_torch.models.common import rope_angles  # noqa: E402
from repro_torch.params import from_jax, tree_leaves  # noqa: E402

SCAN_TOL = 2e-5
TOL = 2e-4
# (b, s, w, chunk, blk_w): the RG-LRU sweep of tests/test_kernels.py; chunk
# and blk_w are the Pallas kernel's tiles
RGLRU_CASES = [(2, 64, 32, 16, 32), (1, 128, 64, 32, 32), (3, 32, 16, 16, 16)]


def _close(got, want, tol=TOL):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol, atol=tol)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _tree_close(got, want, tol=TOL):
    got, want = tree_leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        _close(g, w, tol)


def _hybrid5():
    """recurrentgemma reduced to 5 layers and a window of 8: layers
    (rglru, rglru, attn) scanned once plus the unrolled (rglru, rglru), as
    at full width, with prompts longer than the window."""
    return dataclasses.replace(jget_config("recurrentgemma-9b").reduced(),
                               num_layers=5, window=8)


def _port_cfg(jcfg):
    return ModelConfig(**dataclasses.asdict(jcfg))


def _scan_inputs(b, s, w, seed):
    rng = np.random.default_rng(seed)
    a = 1.0 / (1.0 + np.exp(-rng.standard_normal((b, s, w))))
    return a.astype(np.float32), rng.standard_normal((b, s, w)).astype(np.float32)


# ------------------------------------------------------------------ the scan
@pytest.mark.parametrize("case", RGLRU_CASES)
def test_plain_rglru_scan_matches_pallas_interpret(case):
    b, s, w, chunk, blk_w = case
    a, bb = _scan_inputs(b, s, w, seed=s + w)
    got = ops.rglru_scan(torch.from_numpy(a), torch.from_numpy(bb))
    want = pallas_rglru(jnp.asarray(a), jnp.asarray(bb), chunk=chunk,
                        blk_w=blk_w, interpret=True)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    _close(got, want, SCAN_TOL)


@pytest.mark.parametrize("s", [1, 37])
def test_plain_rglru_scan_takes_ragged_lengths(s):
    """Any S >= 1, against the JAX oracle (the Pallas kernel asserts
    S % chunk == 0), from bfloat16 inputs as well as float32."""
    a, bb = _scan_inputs(2, s, 24, seed=s)
    want = jref.ref_rglru_scan(jnp.asarray(a), jnp.asarray(bb))
    _close(ref.ref_rglru_scan(torch.from_numpy(a), torch.from_numpy(bb)), want,
           SCAN_TOL)
    a16, b16 = (torch.from_numpy(x).bfloat16() for x in (a, bb))
    want16 = jref.ref_rglru_scan(jnp.asarray(a16.float().numpy(), jnp.bfloat16),
                                 jnp.asarray(b16.float().numpy(), jnp.bfloat16))
    got16 = ops.rglru_scan(a16, b16)
    assert got16.dtype == torch.float32
    _close(got16, want16, SCAN_TOL)


# ------------------------------------------------------------------ the kernel's plan
PLAN_DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("dtype", PLAN_DTYPES, ids=str)
def test_rglru_plan_fills_one_wave_at_the_lru_width(dtype):
    """recurrentgemma-9b's prefill (B 1, W 4096): at least 128 CTAs, one
    wave on an H100's 132 SMs."""
    plan = rglru_kernel.rglru_plan(1, 3072, 4096, dtype)
    assert 128 <= plan.grid[0] * plan.grid[1] <= 132


@pytest.mark.parametrize("dtype", PLAN_DTYPES, ids=str)
@pytest.mark.parametrize("s", [1, 16, 37, 127, 128, 129, 255, 256, 257, 2085, 3072,
                               8192])
def test_rglru_plan_slabs_cover_s_within_shared_memory(s, dtype):
    """The slabs cover S exactly (a ragged last slab included), a slab
    splits evenly among the warps, S past one slab goes round a ring of at
    least two stages, and the ring with the kernel's static arrays fits a
    CTA's 232,448 bytes of shared memory."""
    plan = rglru_kernel.rglru_plan(4, s, 4096, dtype)
    item = torch.empty((), dtype=dtype).element_size()
    assert (plan.slabs - 1) * plan.rows < s <= plan.slabs * plan.rows
    assert plan.rows % rglru_kernel.WARPS == 0
    assert plan.stages >= 2 if plan.slabs > 1 else plan.stages == 1
    assert plan.smem == plan.stages * 2 * plan.rows * rglru_kernel.CHANNELS * item
    assert plan.smem + rglru_kernel.STATIC_SMEM <= 232448
    assert plan.grid == (128, 4)


@pytest.mark.parametrize("w,dtype", [(4102, torch.float32), (4100, torch.bfloat16),
                                     (6, torch.float32), (20, torch.bfloat16)])
def test_rglru_plan_rejects_rows_off_16_bytes(w, dtype):
    with pytest.raises(ValueError, match="16 bytes"):
        rglru_kernel.rglru_plan(1, 128, w, dtype)


def _ring_schedule(a, b, plan):
    """The kernel's order of arithmetic in numpy float32: per slab, each
    sub-chunk scanned from zero with the product of its a's, a log-depth
    (Hillis-Steele) scan of the sub-chunks' maps with the carry folded into
    the first, then each sub-chunk again from its carry-in."""
    bsz, s, w = a.shape
    h = np.empty((bsz, s, w), np.float32)
    carry = np.zeros((bsz, w), np.float32)
    sub = plan.rows // rglru_kernel.WARPS
    for k in range(plan.slabs):
        t0, n = k * plan.rows, min(plan.rows, s - k * plan.rows)
        p = np.ones((rglru_kernel.WARPS, bsz, w), np.float32)
        e = np.zeros((rglru_kernel.WARPS, bsz, w), np.float32)
        spans = [(t0 + j * sub, t0 + min((j + 1) * sub, n))
                 for j in range(rglru_kernel.WARPS)]
        for j, (r0, r1) in enumerate(spans):
            for t in range(r0, r1):
                e[j] = a[:, t] * e[j] + b[:, t]
                p[j] = p[j] * a[:, t]
        e[0] = p[0] * carry + e[0]
        d = 1
        while d < rglru_kernel.WARPS:
            e[d:], p[d:] = p[d:] * e[:-d] + e[d:], p[d:] * p[:-d]
            d *= 2
        cin = np.concatenate([carry[None], e[:-1]])
        carry = e[-1]
        for j, (r0, r1) in enumerate(spans):
            hh = cin[j]
            for t in range(r0, r1):
                hh = a[:, t] * hh + b[:, t]
                h[:, t] = hh
    return h


@pytest.mark.parametrize("s", [1, 37, 129, 300])
def test_rglru_kernel_schedule_matches_jax(s):
    """The kernel's slabs, sub-chunks and combine, as ``rglru_plan`` lays
    them out, give the JAX oracle's h (ragged last slab and sub-chunks, and
    slabs past the first, included)."""
    a, bb = _scan_inputs(2, s, 24, seed=s)
    plan = rglru_kernel.rglru_plan(2, s, 24, torch.float32)
    want = jref.ref_rglru_scan(jnp.asarray(a), jnp.asarray(bb))
    _close(_ring_schedule(a, bb, plan), want, SCAN_TOL)


# ------------------------------------------------------------------ layers
def _layer_params(init, jcfg, seed):
    jp = init(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    return jp, from_jax(_np(jp), "cpu")


def test_rglru_context_and_decode_match_jax():
    jcfg = jget_config("recurrentgemma-9b").reduced()
    jp, tp = _layer_params(jrglru.rglru_init, jcfg, 1)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 21, jcfg.d_model)).astype(np.float32)
    jout, jcache = jrglru.rglru_context(jp, jcfg, jnp.asarray(x), return_cache=True)
    out, cache = rglru.rglru_context(tp, _port_cfg(jcfg), torch.from_numpy(x),
                                     return_cache=True)
    _close(out, jout)
    _tree_close(cache, jcache)
    # three decode steps from the context's cache
    for step in range(3):
        xt = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
        jout, jcache = jrglru.rglru_decode(jp, jcfg, jnp.asarray(xt), jcache)
        out, cache = rglru.rglru_decode(tp, _port_cfg(jcfg), torch.from_numpy(xt),
                                        cache)
        _close(out, jout)
        _tree_close(cache, jcache)


def _ropes(jcfg, positions):
    jcos, jsin = jcommon.rope_angles(jnp.asarray(positions), jcfg.head_dim,
                                     jcfg.rope_theta)
    cos, sin = rope_angles(torch.from_numpy(positions), jcfg.head_dim,
                           jcfg.rope_theta)
    return (jcos, jsin), (cos, sin)


@pytest.mark.parametrize("branch", ["full-scores", "flash"])
@pytest.mark.parametrize("masks", ["causal", "window", "window+seq_lens"])
def test_attn_context_matches_jax(monkeypatch, branch, masks):
    """Both branches of ``attn_context``: the flash one with both packages'
    thresholds lowered so a short sequence takes it."""
    if branch == "flash":
        for mod in (jattn, attn):
            monkeypatch.setattr(mod, "FLASH_THRESHOLD", 8)
            monkeypatch.setattr(mod, "FLASH_BLOCK", 4)
    jcfg = _hybrid5()
    jp, tp = _layer_params(jattn.attn_init, jcfg, 2)
    b, s = 2, 24
    rng = np.random.default_rng(6)
    x = rng.standard_normal((b, s, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    (jcos, jsin), (cos, sin) = _ropes(jcfg, pos)
    window = 0 if masks == "causal" else jcfg.window
    seq_lens = np.array([24, 13], np.int32) if masks.endswith("seq_lens") else None
    jout, jcache = jattn.attn_context(
        jp, jcfg, jnp.asarray(x), jcos, jsin, window=window,
        seq_lens=None if seq_lens is None else jnp.asarray(seq_lens),
        return_cache=True)
    out, cache = attn.attn_context(
        tp, _port_cfg(jcfg), torch.from_numpy(x), cos, sin, window=window,
        seq_lens=None if seq_lens is None else torch.from_numpy(seq_lens),
        return_cache=True)
    _close(out, jout)
    _tree_close(cache, jcache)


def test_attn_decode_across_ring_wrap_matches_jax():
    """Twelve steps through a ring of 8 slots: the ring wraps, every step's
    output and ring equal JAX's, and the ring given is never written."""
    jcfg = _hybrid5()
    jp, tp = _layer_params(jattn.attn_init, jcfg, 3)
    b, sc = 2, jcfg.window
    shp = (b, sc, jcfg.num_kv_heads, jcfg.head_dim)
    jcache = {"k": jnp.zeros(shp), "v": jnp.zeros(shp)}
    cache = {"k": torch.zeros(shp), "v": torch.zeros(shp)}
    rng = np.random.default_rng(7)
    for step in range(12):
        pos = np.array([step, step + 3], np.int32)
        x = rng.standard_normal((b, 1, jcfg.d_model)).astype(np.float32)
        (jcos, jsin), (cos, sin) = _ropes(jcfg, pos[:, None])
        jout, jcache = jattn.attn_decode(jp, jcfg, jnp.asarray(x), jcos, jsin,
                                         jcache, jnp.asarray(pos))
        before = [t.clone() for t in cache.values()]
        out, new = attn.attn_decode(tp, _port_cfg(jcfg), torch.from_numpy(x),
                                    cos, sin, cache, torch.from_numpy(pos))
        assert all(torch.equal(a, t) for a, t in zip(before, cache.values()))
        cache = new
        _close(out, jout)
        _tree_close(cache, jcache)


# ------------------------------------------------------------------ models
def _pair(jcfg, seed=0):
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    tm = Model(_port_cfg(jcfg))
    return (jm, jp), (tm, from_jax(_np(jp), "cpu"))


@pytest.fixture(scope="module", params=["hybrid5", "reduced"])
def models(request):
    jcfg = _hybrid5() if request.param == "hybrid5" else \
        jget_config("recurrentgemma-9b").reduced()
    return _pair(jcfg)


@pytest.mark.parametrize("plen,total", [(5, 12), (39, 45)],
                         ids=["pad", "ring-remap"])
def test_prefill_pad_cache_and_decode_match_jax(models, plen, total):
    """``Model.prefill`` logits and cache, ``pad_cache`` (padding a short
    prefill; on the 5-layer variant remapping a long one onto ring slots
    pos % window) and decode steps past the prefill, wrapping the ring."""
    (jm, jp), (tm, tp) = models
    vocab = tm.cfg.vocab_size
    toks = np.random.default_rng(plen).integers(0, vocab, (1, plen)).astype(np.int32)
    jlast, jcache = jm.prefill(jp, jnp.asarray(toks))
    last, cache = tm.prefill(tp, torch.from_numpy(toks))
    _close(last, jlast)
    _tree_close(cache, jcache)
    jcache = jm.pad_cache(jcache, plen, total)
    cache = tm.pad_cache(cache, plen, total)
    _tree_close(cache, jcache)
    cur = int(np.argmax(np.asarray(jlast[0])))
    assert cur == int(torch.argmax(last[0]))
    for pos in range(plen, total - 1):
        jlg, jcache = jm.decode_step(jp, jnp.asarray([cur], jnp.int32), jcache,
                                     jnp.asarray([pos], jnp.int32))
        lg, cache = tm.decode_step(tp, torch.tensor([cur]), cache, torch.tensor([pos]))
        _close(lg, jlg)
        _tree_close(cache, jcache)
        cur = int(np.argmax(np.asarray(jlg[0])))


def test_prefill_with_seq_lens_matches_jax(models):
    """Right-padded rows: each row's logits at its own last position."""
    (jm, jp), (tm, tp) = models
    toks = np.random.default_rng(9).integers(0, tm.cfg.vocab_size,
                                             (2, 19)).astype(np.int32)
    lens = np.array([19, 11], np.int32)
    jlast, jcache = jm.prefill(jp, jnp.asarray(toks), seq_lens=jnp.asarray(lens))
    last, cache = tm.prefill(tp, torch.from_numpy(toks),
                             seq_lens=torch.from_numpy(lens))
    _close(last, jlast)
    _tree_close(cache, jcache)


def test_make_cache_matches_jax(models):
    (jm, _), (tm, _) = models
    want = jm.make_cache(2, 40, as_specs=True)
    got = tm.make_cache(2, 40, device="cpu")
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        assert tuple(g.shape) == w.shape and str(g.dtype)[6:] == str(w.dtype)
        assert not g.any()
    assert tm.cache_bytes(2, 40) == jm.cache_bytes(2, 40)


def test_from_jax_carries_a_bf16_hybrid_tree():
    """A bfloat16 hybrid: the stacked scan segment, the unrolled one, an
    empty scan segment (0-size leaves) and the float32 gate parameters."""
    for layers in (5, 2):
        jcfg = dataclasses.replace(_hybrid5(), num_layers=layers, dtype="bfloat16")
        (jm, jp), (tm, tp) = _pair(jcfg)
        want = jax.tree.leaves(jp)
        got = tree_leaves(tp)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert tuple(g.shape) == w.shape and str(g.dtype)[6:] == str(w.dtype)
            assert np.array_equal(g.float().numpy(), np.asarray(w, np.float32))
        scan_rglru = tp["layers"][0][0]["rglru"]
        assert scan_rglru["wx"].dtype == torch.bfloat16
        assert all(scan_rglru[k].dtype == torch.float32
                   for k in ("lam", "wr", "br", "wi", "bi"))
        assert scan_rglru["wx"].shape[0] == layers // 3


def test_full_width_state_sizes_match_jax_without_allocating():
    """One recurrentgemma-9b snapshot: 12 window rings of (2048, 1, 256)
    bf16 k and v, and 26 RG-LRU states (conv (4, 4096) bf16, h (4096) f32)."""
    cfg = get_config("recurrentgemma-9b")
    tm, jm = Model(cfg), JModel(jget_config("recurrentgemma-9b"))
    assert tm.cache_bytes(1, 2048) == jm.cache_bytes(1, 2048) == 26_443_776
    assert io_spec_for_model(tm).block_bytes(32) == jio_spec(jm).block_bytes(32)
    specs = tm.make_cache(1, 2048, as_specs=True)
    assert all(t.device.type == "meta" for t in tree_leaves(specs))
