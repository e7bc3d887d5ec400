"""The port's routed MoE against the JAX package's, float32 on the CPU:
``_route`` (dispatch exact, combine to 1e-6, ties to the first index),
``moe_apply`` (1e-5, with and without a shared expert, a token count off
the group), the sensitivity to padded rows once capacity binds, the dense
path (``Model.prefill`` / ``pad_cache`` / ``decode_step``) of qwen3-moe
reduced (1e-4), and the engine's greedy tokens and scheduling decisions
against the JAX engine, with a host-tier round trip.

Routing is discrete: a float32 difference of 1e-7 can flip an argmax near
a tie. The tests that compare routing assert that no two gates of a live
token lie within ``MARGIN`` of each other, so a seed cannot hide a fault
behind a tie it happens not to meet."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core  # noqa: E402,F401  (package import order: core before models.paged)
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.params import from_jax, tree_leaves  # noqa: E402
from tests.test_torch_engine import ENGINE_KW, _compare, _prompt  # noqa: E402

MARGIN = 1e-6


def _port_cfg(jcfg):
    return ModelConfig(**dataclasses.asdict(jcfg))


def _moe_cfg(capacity_factor=8.0, shared=False):
    """qwen3-moe reduced: d 256, 4 experts of d_ff 512, top-2, float32."""
    return dataclasses.replace(jget_config("qwen3-moe-30b-a3b").reduced(),
                               capacity_factor=capacity_factor,
                               shared_expert=shared)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _min_gap(gates):
    """The smallest distance between two gates of one token, (..., E)."""
    g = np.sort(np.asarray(gates, np.float64).reshape(-1, gates.shape[-1]), axis=-1)
    return float(np.diff(g, axis=-1).min())


def _capacity(group, cf, top_k, e):
    return max(int(np.ceil(group * cf * top_k / e)), 1)


# ---------------------------------------------------------------- routing
@pytest.mark.parametrize("cf", [8.0, 0.5])
def test_route_matches_jax(cf):
    n, g, e, top_k = 2, 24, 8, 3
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((n, g, e)).astype(np.float32)
    gates = np.array(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    assert _min_gap(gates) > MARGIN
    cap = _capacity(g, cf, top_k, e)
    jd, jc = jmoe._route(jnp.asarray(gates), top_k, cap)
    d, c = moe._route(torch.from_numpy(gates), top_k, cap)
    assert d.dtype == c.dtype == torch.float32 and tuple(d.shape) == (n, g, e, cap)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-6, atol=1e-6)
    kept = int(d.sum())
    if cf < 1:
        assert kept < n * g * top_k, "capacity 0.5 must drop choices"
    else:
        assert kept == n * g * top_k


def test_route_ties_go_to_the_first_index():
    """Equal gates (a zero row's softmax): each choice takes the lowest
    index still unchosen, in both packages."""
    n, g, e, top_k = 1, 5, 4, 2
    gates = np.full((n, g, e), 1.0 / e, np.float32)
    cap = _capacity(g, 0.5, top_k, e)
    jd, jc = jmoe._route(jnp.asarray(gates), top_k, cap)
    d, c = moe._route(torch.from_numpy(gates), top_k, cap)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-6, atol=1e-6)
    assert d[0, :, 0].sum() == cap and d[0, :, 1].sum() == cap
    assert d[0, :, 2:].sum() == 0


# ---------------------------------------------------------------- moe_apply
def _moe_params(jcfg, seed):
    jp = jmoe.moe_init(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    return jp, from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _live_gap(jp, x, live_rows):
    """Gap of the router's gates over the live rows of x (B, S, d)."""
    xt = x.reshape(-1, x.shape[-1])[:live_rows]
    logits = np.asarray(jnp.asarray(xt) @ jp["router"])
    return _min_gap(np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1)))


@pytest.mark.parametrize("shape", [(2, 5), (3, 100)], ids=["one-group", "padded-group"])
@pytest.mark.parametrize("cf", [8.0, 0.5])
@pytest.mark.parametrize("shared", [False, True], ids=["routed", "shared-expert"])
def test_moe_apply_matches_jax(shape, cf, shared):
    """(3, 100) is 300 tokens: a group of 256 and 212 zero rows of padding."""
    jcfg = _moe_cfg(cf, shared)
    jp, tp = _moe_params(jcfg, 1)
    rng = np.random.default_rng(2)
    x = rng.standard_normal(shape + (jcfg.d_model,)).astype(np.float32)
    assert _live_gap(jp, x, shape[0] * shape[1]) > MARGIN
    want = jmoe.moe_apply(jp, jcfg, jnp.asarray(x))
    got = moe.moe_apply(tp, _port_cfg(jcfg), torch.from_numpy(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_padded_rows_change_the_result_once_capacity_binds():
    """A decode batch of 5 padded to 8, as the runner pads it: at capacity
    factor 0.5 the padded rows take capacity from the live ones, so the live
    rows' output differs from a batch of the live rows alone (what slicing
    the padding away before the MoE would give), and the port equals JAX
    on the padded batch. At capacity factor 8.0 nothing is dropped and the
    padding changes nothing. Seed 7 is one where a padded row's first
    choice takes a slot a live row's second choice needs (at seeds 3-6 it
    does not, and both batches agree)."""
    rng = np.random.default_rng(7)
    d = _moe_cfg().d_model
    live = rng.standard_normal((5, 1, d)).astype(np.float32)
    pad_row = rng.standard_normal((1, 1, d)).astype(np.float32)
    padded = np.concatenate([live] + [pad_row] * 3)
    diffs = {}
    for cf in (0.5, 8.0):
        jcfg = _moe_cfg(cf)
        jp, tp = _moe_params(jcfg, 4)
        assert _live_gap(jp, padded, 6) > MARGIN
        cfg = _port_cfg(jcfg)
        out_padded = moe.moe_apply(tp, cfg, torch.from_numpy(padded))
        out_live = moe.moe_apply(tp, cfg, torch.from_numpy(live))
        np.testing.assert_allclose(out_padded.numpy(),
                                   np.asarray(jmoe.moe_apply(jp, jcfg, jnp.asarray(padded))),
                                   rtol=1e-5, atol=1e-5)
        diffs[cf] = float((out_padded[:5] - out_live).abs().max())
    assert diffs[0.5] > 1e-2, diffs
    assert diffs[8.0] < 1e-5, diffs


def test_moe_init_layout_and_scale():
    """``moe_init`` with a layer axis: the JAX layout, a float32 router,
    each layer drawn on its own at the reference's scale."""
    jcfg = _moe_cfg(shared=True)
    cfg = dataclasses.replace(_port_cfg(jcfg), dtype="bfloat16")
    p = moe.moe_init(torch.Generator().manual_seed(0), cfg, torch.bfloat16, lead=(3,))
    jp = jmoe.moe_init(jax.random.PRNGKey(0), jcfg, jnp.bfloat16)
    assert sorted(p) == sorted(jp)
    for t, a in zip(tree_leaves(p), jax.tree.leaves(jp)):
        assert tuple(t.shape) == (3,) + a.shape
        assert str(t.dtype)[6:] == str(a.dtype)
    d, ff = cfg.d_model, cfg.d_ff
    for name, fan_in in (("router", d), ("we1", d), ("we3", d), ("we2", ff)):
        w = p[name].float()
        for layer in range(3):
            assert abs(float(w[layer].std()) * np.sqrt(fan_in) - 1) < 0.05
        assert not torch.equal(w[0], w[1])


# ---------------------------------------------------------------- dense path
def _pair(jcfg, seed=0):
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    return (jm, jp), (Model(_port_cfg(jcfg)), from_jax(jax.tree.map(np.asarray, jp), "cpu"))


@pytest.fixture(scope="module", params=[8.0, 0.5], ids=["cf8", "cf0.5"])
def models(request):
    return _pair(_moe_cfg(request.param))


def _close(got, want, tol=1e-4):
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), rtol=tol, atol=tol)


def test_prefill_pad_cache_and_decode_match_jax(models):
    """Two rows of 21 tokens (42 tokens, one group), ``pad_cache`` and
    four decode steps of the batch of two."""
    (jm, jp), (tm, tp) = models
    plen, total = 21, 27
    toks = np.random.default_rng(5).integers(0, tm.cfg.vocab_size,
                                             (2, plen)).astype(np.int32)
    jlast, jcache = jm.prefill(jp, jnp.asarray(toks))
    last, cache = tm.prefill(tp, torch.from_numpy(toks))
    _close(last, jlast)
    for g, w in zip(tree_leaves(cache), jax.tree.leaves(jcache)):
        _close(g, w)
    jcache = jm.pad_cache(jcache, plen, total)
    cache = tm.pad_cache(cache, plen, total)
    cur = np.argmax(np.asarray(jlast), axis=-1).astype(np.int32)
    assert np.array_equal(cur, torch.argmax(last, dim=-1).numpy())
    for pos in range(plen, plen + 4):
        p = np.full((2,), pos, np.int32)
        jlg, jcache = jm.decode_step(jp, jnp.asarray(cur), jcache, jnp.asarray(p))
        lg, cache = tm.decode_step(tp, torch.from_numpy(cur).long(), cache,
                                   torch.from_numpy(p))
        _close(lg, jlg)
        for g, w in zip(tree_leaves(cache), jax.tree.leaves(jcache)):
            _close(g, w)
        cur = np.argmax(np.asarray(jlg), axis=-1).astype(np.int32)


# ---------------------------------------------------------------- engine
def test_engine_matches_jax_engine(models):
    rng = np.random.default_rng(0)
    vocab = models[0][0].cfg.vocab_size
    specs = [(_prompt(rng, vocab, n), 6, "OFFLINE", 0.0, None) for n in (13, 25, 40)]
    _compare(models, specs, **ENGINE_KW)


def test_host_tier_swap_matches_jax_engine(models):
    """tests/test_torch_engine.py's swap scenario on the MoE model: an
    offline request preempted, parked on the host tier and restored."""
    rng = np.random.default_rng(2)
    vocab = models[0][0].cfg.vocab_size
    specs = [(_prompt(rng, vocab, 56), 6, "OFFLINE", 0.0, None),
             (_prompt(rng, vocab, 88), 12, "ONLINE", None, (10, 10))]
    jeng, teng, _, treqs = _compare(
        models, specs, steps_first=3, num_blocks=16, block_size=8,
        chunk_size=16, max_pages_per_seq=16, host_kv_blocks=32)
    assert treqs[0].n_preemptions >= 1
    assert teng.bm.metrics.swapped_out_tokens > 0
    assert teng.bm.metrics.swapped_in_tokens > 0
    assert teng.stats.swapped_in_bytes == jeng.stats.swapped_in_bytes
