"""The port's multimodal configs against the JAX package's, float32 on the
CPU: the registry (all ten architectures, field by field), the parameter
trees (``mm_proj`` included), ``Model.prefill`` with conditioning
embeddings (logits and caches to 1e-5; qwen2-vl also with distinct M-RoPE
rows and ``seq_lens``), ``pad_cache`` -> ``decode_step`` greedy tokens, the
engine's tokens and scheduling decisions through ``TorchPagedRunner``
(llama4-scout at capacity factors 8.0 and 0.5, with and without the host
tier), and top-1 routing with the shared expert (``dispatch`` exact).

Routing is discrete: the routing tests assert that no two gates of a token
lie within ``MARGIN`` of each other, so a seed cannot hide a fault behind
a tie it happens not to meet."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core  # noqa: E402,F401  (package import order: core before models.paged)
from repro import configs as jconfigs  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.params import from_jax, tree_leaves  # noqa: E402
from tests.test_torch_engine import ENGINE_KW, _compare, _prompt  # noqa: E402

MM_ARCHS = ("musicgen-medium", "qwen2-vl-72b", "llama4-scout-17b-a16e")
TOL = 1e-5
MARGIN = 1e-6


def _reduced(arch, **kw):
    return dataclasses.replace(jconfigs.get_config(arch).reduced(), **kw)


def _pair(jcfg, seed=0):
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    tm = Model(ModelConfig(**dataclasses.asdict(jcfg)))
    return (jm, jp), (tm, from_jax(jax.tree.map(np.asarray, jp), "cpu"))


@pytest.fixture(scope="module", params=MM_ARCHS)
def models(request):
    return _pair(_reduced(request.param))


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _tree_close(got, want):
    g, w = tree_leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert tuple(a.shape) == b.shape
        _close(a, b)


def _min_gap(gates):
    g = np.sort(np.asarray(gates, np.float64).reshape(-1, gates.shape[-1]), axis=-1)
    return float(np.diff(g, axis=-1).min())


# ---------------------------------------------------------------- registry
def test_registry_names_the_jax_architectures():
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS
    assert len(configs.ARCH_IDS) == 10


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_config_equals_jax_field_by_field(arch):
    got, want = configs.get_config(arch), jconfigs.get_config(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(got.reduced()) == dataclasses.asdict(want.reduced())
    assert got.param_count == want.param_count


# ---------------------------------------------------------------- params
@pytest.mark.parametrize("arch", MM_ARCHS)
def test_param_trees_have_the_same_keys(arch):
    """The port's own init and the carried-over JAX tree: the same keys,
    ``mm_proj`` among them, with the same shapes and dtypes."""
    jcfg = _reduced(arch)
    jp = JModel(jcfg).init(jax.random.PRNGKey(0))
    tp = Model(ModelConfig(**dataclasses.asdict(jcfg))).init(torch.Generator().manual_seed(0))
    assert "mm_proj" in tp and sorted(tp) == sorted(jp)
    assert tuple(tp["mm_proj"].shape) == (jcfg.mm_embed_dim, jcfg.d_model)
    carried = from_jax(jax.tree.map(np.asarray, jp), "cpu")
    assert sorted(carried) == sorted(jp)
    assert tuple(carried["mm_proj"].shape) == jp["mm_proj"].shape
    got, want = tree_leaves(tp), jax.tree.leaves(jp)
    assert [tuple(t.shape) for t in got] == [a.shape for a in want]
    assert [str(t.dtype)[6:] for t in got] == [str(a.dtype) for a in want]


# ---------------------------------------------------------------- dense path
def _inputs(cfg, seed, b=2, s=20, frames=6):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    mm = rng.standard_normal((b, frames, cfg.mm_embed_dim)).astype(np.float32)
    return toks, mm


@pytest.mark.parametrize("rows", [1, 2], ids=["first-row", "both-rows"])
def test_prefill_with_mm_embeds_matches_jax(models, rows):
    """Conditioning frames over the first ``rows`` rows: logits and caches
    equal JAX's to 1e-5, and the frames change the logits of the rows they
    cover."""
    (jm, jp), (tm, tp) = models
    toks, mm = _inputs(tm.cfg, 3)
    mm = mm[:rows]
    jlast, jcache = jm.prefill(jp, jnp.asarray(toks), jnp.asarray(mm))
    last, cache = tm.prefill(tp, torch.from_numpy(toks), torch.from_numpy(mm))
    _close(last, jlast)
    _tree_close(cache, jcache)
    bare, _ = tm.prefill(tp, torch.from_numpy(toks))
    moved = (last - bare).abs().amax(-1)
    assert bool((moved[:rows] > 1e-3).all())
    assert bool((moved[rows:] < 1e-6).all())


def test_prefill_rejects_frames_longer_than_the_tokens(models):
    (_, _), (tm, tp) = models
    toks, mm = _inputs(tm.cfg, 4, s=5, frames=6)
    with pytest.raises(ValueError, match="do not fit"):
        tm.prefill(tp, torch.from_numpy(toks), torch.from_numpy(mm))


def test_qwen2_vl_prefill_with_mrope_positions_and_seq_lens_matches_jax():
    """Three distinct M-RoPE rows (time, height, width of a patch grid) and
    right padding, with frames over both rows."""
    (jm, jp), (tm, tp) = _pair(_reduced("qwen2-vl-72b"))
    b, s = 2, 18
    toks, mm = _inputs(tm.cfg, 5, b=b, s=s, frames=8)
    grid = np.arange(s)
    pos = np.stack([np.broadcast_to(grid // 6, (b, s)),       # time
                    np.broadcast_to((grid // 3) % 2, (b, s)),  # height
                    np.broadcast_to(grid % 3, (b, s))]).astype(np.int32)
    pos[:, 1] += 2
    assert not np.array_equal(pos[0], pos[1]) and not np.array_equal(pos[1], pos[2])
    lens = np.array([s, 11], np.int32)
    jlast, jcache = jm.prefill(jp, jnp.asarray(toks), jnp.asarray(mm),
                               seq_lens=jnp.asarray(lens), positions=jnp.asarray(pos))
    last, cache = tm.prefill(tp, torch.from_numpy(toks), torch.from_numpy(mm),
                             seq_lens=torch.from_numpy(lens),
                             positions=torch.from_numpy(pos))
    _close(last, jlast)
    _tree_close(cache, jcache)
    flat, _ = tm.prefill(tp, torch.from_numpy(toks), torch.from_numpy(mm),
                         seq_lens=torch.from_numpy(lens))
    assert float((flat - last).abs().max()) > 1e-3, "the M-RoPE rows must matter"


def test_pad_cache_and_decode_tokens_match_jax(models):
    """Prefill with frames, ``pad_cache``, then six greedy decode steps of
    the batch of two: equal tokens, logits to 1e-5."""
    (jm, jp), (tm, tp) = models
    toks, mm = _inputs(tm.cfg, 6)
    plen, steps = toks.shape[1], 6
    jlast, jcache = jm.prefill(jp, jnp.asarray(toks), jnp.asarray(mm))
    last, cache = tm.prefill(tp, torch.from_numpy(toks), torch.from_numpy(mm))
    jcache = jm.pad_cache(jcache, plen, plen + steps + 1)
    cache = tm.pad_cache(cache, plen, plen + steps + 1)
    jcur = np.argmax(np.asarray(jlast), -1).astype(np.int32)
    cur = torch.argmax(last, -1)
    jtoks, ttoks = [jcur], [cur.numpy()]
    for pos in range(plen, plen + steps):
        p = np.full((2,), pos, np.int32)
        jlg, jcache = jm.decode_step(jp, jnp.asarray(jcur), jcache, jnp.asarray(p))
        lg, cache = tm.decode_step(tp, cur, cache, torch.from_numpy(p))
        _close(lg, jlg)
        jcur = np.argmax(np.asarray(jlg), -1).astype(np.int32)
        cur = torch.argmax(lg, -1)
        jtoks.append(jcur)
        ttoks.append(cur.numpy())
    assert np.array_equal(np.stack(ttoks), np.stack(jtoks))


# ---------------------------------------------------------------- engine
def test_engine_matches_jax_engine(models):
    """The paged runner embeds tokens only (no frames), as JAX's does; on
    qwen2-vl it expands the positions to three equal M-RoPE rows."""
    rng = np.random.default_rng(0)
    vocab = models[0][0].cfg.vocab_size
    specs = [(_prompt(rng, vocab, n), 6, "OFFLINE", 0.0, None) for n in (13, 25, 40)]
    _compare(models, specs, **ENGINE_KW)


@pytest.fixture(scope="module", params=[8.0, 0.5], ids=["cf8", "cf0.5"])
def scout(request):
    return _pair(_reduced("llama4-scout-17b-a16e", capacity_factor=request.param))


def test_scout_engine_matches_jax_engine(scout):
    rng = np.random.default_rng(1)
    vocab = scout[0][0].cfg.vocab_size
    specs = [(_prompt(rng, vocab, n), 6, "OFFLINE", 0.0, None) for n in (9, 30, 44)]
    _compare(scout, specs, **ENGINE_KW)


def test_scout_host_tier_swap_matches_jax_engine(scout):
    """tests/test_torch_engine.py's swap scenario: an offline request
    preempted, parked on the host tier and restored."""
    rng = np.random.default_rng(2)
    vocab = scout[0][0].cfg.vocab_size
    specs = [(_prompt(rng, vocab, 56), 6, "OFFLINE", 0.0, None),
             (_prompt(rng, vocab, 88), 12, "ONLINE", None, (10, 10))]
    jeng, teng, _, treqs = _compare(
        scout, specs, steps_first=3, num_blocks=16, block_size=8,
        chunk_size=16, max_pages_per_seq=16, host_kv_blocks=32)
    assert treqs[0].n_preemptions >= 1
    assert teng.bm.metrics.swapped_out_tokens > 0
    assert teng.bm.metrics.swapped_in_tokens > 0
    assert teng.stats.swapped_in_bytes == jeng.stats.swapped_in_bytes


# ---------------------------------------------------------------- routing
@pytest.mark.parametrize("cf", [8.0, 0.5])
def test_top1_route_matches_jax(cf):
    """Top-1 (llama4-scout's routing): ``dispatch`` exact; each kept token's
    combine weight is exactly 1 after renormalisation."""
    n, g, e = 2, 40, 4
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((n, g, e)).astype(np.float32)
    gates = np.array(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    assert _min_gap(gates) > MARGIN
    cap = max(int(np.ceil(g * cf * 1 / e)), 1)
    jd, jc = jmoe._route(jnp.asarray(gates), 1, cap)
    d, c = moe._route(torch.from_numpy(gates), 1, cap)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-6, atol=1e-6)
    kept = d.sum((-2, -1)) > 0                          # (n, g)
    assert torch.equal(c.sum((-2, -1))[kept], torch.ones(int(kept.sum())))
    assert (int(kept.sum()) < n * g) == (cf < 1)


@pytest.mark.parametrize("cf", [8.0, 0.5])
def test_top1_shared_expert_moe_apply_matches_jax(cf):
    """llama4-scout reduced's MoE layer: top-1 routed plus the shared
    expert, 1e-5."""
    jcfg = _reduced("llama4-scout-17b-a16e", capacity_factor=cf)
    assert jcfg.top_k == 1 and jcfg.shared_expert
    jp = jmoe.moe_init(jax.random.PRNGKey(1), jcfg, jnp.float32)
    tp = from_jax(jax.tree.map(np.asarray, jp), "cpu")
    assert "shared" in tp
    x = np.random.default_rng(2).standard_normal((3, 30, jcfg.d_model)).astype(np.float32)
    gates = np.array(jax.nn.softmax(jnp.asarray(x.reshape(-1, jcfg.d_model)) @ jp["router"],
                                    axis=-1))
    assert _min_gap(gates) > MARGIN
    want = jmoe.moe_apply(jp, jcfg, jnp.asarray(x))
    got = moe.moe_apply(tp, ModelConfig(**dataclasses.asdict(jcfg)), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
