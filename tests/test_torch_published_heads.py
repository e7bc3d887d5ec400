"""llama4-scout-17b-a16e and qwen2-vl-72b at their published head geometry
and routing, the port against the JAX package in float32 on the CPU.

``.reduced()`` cuts heads to 4 of hd 32, experts to 4 at capacity factor
8.0 and M-RoPE sections to (8, 4, 4). Here each config keeps its published
``num_heads``, ``num_kv_heads``, ``head_dim`` 128, ``mrope_sections``
(16, 24, 24), ``num_experts`` 16, ``top_k`` 1, ``capacity_factor`` 1.25,
``shared_expert`` and ``mm_embed_dim``; only ``d_model``, ``d_ff``,
``vocab_size`` and the depth are cut (``CUT``), the same
``dataclasses.replace`` on the JAX config and on the port's.

Cases: ``Model.prefill`` with frames (qwen2-vl also with three distinct
M-RoPE rows and ``seq_lens``) to 1e-5; ``pad_cache`` -> ``decode_step``
greedy tokens; the engine's tokens and scheduling decisions against the
JAX engine under both decode schedules; and llama4-scout's routing with
16 experts at capacity factor 1.25 (``dispatch`` exact, ``moe_apply`` to
1e-5) on a chunk group of 64 and a decode batch of 5 padded to 8, where
capacity 1 drops most choices to the shared expert alone.

Routing is discrete: the routing cases assert that no two gates of a
token lie within ``MARGIN`` of each other, so a seed cannot hide a fault
behind a tie it happens not to meet."""
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
from repro_torch.params import from_jax  # noqa: E402
from tests.test_torch_engine import ENGINE_KW, _compare, _prompt  # noqa: E402
from tests.test_torch_multimodal import (  # noqa: E402
    MARGIN, _close, _inputs, _min_gap, _tree_close)

ARCHS = ("llama4-scout-17b-a16e", "qwen2-vl-72b")
SCOUT = ARCHS[0]
CUT = dict(d_model=256, d_ff=256, vocab_size=512, num_layers=2, dtype="float32")
# the fields that stay at their published values
KEPT = ("num_heads", "num_kv_heads", "head_dim", "mrope_sections", "num_experts",
        "top_k", "capacity_factor", "shared_expert", "mm_embed_dim")
# llama4-scout's routing cases: (rows, live rows) of x (B, S, d); the
# decode batch's padded rows are copies of one row
ROUTE_CASES = {"chunk64": ((1, 64), 64), "decode5pad8": ((8, 1), 5)}


def _cut(arch):
    return dataclasses.replace(jconfigs.get_config(arch), **CUT)


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    jcfg = _cut(request.param)
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tcfg = dataclasses.replace(configs.get_config(request.param), **CUT)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    tm = Model(tcfg)
    return (jm, jp), (tm, from_jax(jax.tree.map(np.asarray, jp), "cpu"))


# ---------------------------------------------------------------- config
@pytest.mark.parametrize("arch", ARCHS)
def test_cut_keeps_the_published_heads_and_routing(arch):
    published, cut = configs.get_config(arch), _cut(arch)
    assert {f: getattr(cut, f) for f in KEPT} == {f: getattr(published, f) for f in KEPT}
    assert cut.head_dim == 128 and cut.num_heads // cut.num_kv_heads in (5, 8)
    if published.mrope_sections:
        assert sum(cut.mrope_sections) == cut.head_dim // 2


# ---------------------------------------------------------------- dense path
def test_prefill_with_frames_matches_jax(models):
    """Frames over the first row: logits and caches equal JAX's to 1e-5,
    with and without the frames, and the frames move that row's logits.
    On qwen2-vl the other row stays as it was; on llama4-scout both rows'
    40 tokens are one routing group whose capacity binds at 1.25, so the
    frames' row takes other expert slots and moves the other row too, in
    the reference as in the port."""
    (jm, jp), (tm, tp) = models
    toks, mm = _inputs(tm.cfg, 3)
    mm = mm[:1]
    jlast, jcache = jm.prefill(jp, jnp.asarray(toks), jnp.asarray(mm))
    last, cache = tm.prefill(tp, torch.from_numpy(toks), torch.from_numpy(mm))
    _close(last, jlast)
    _tree_close(cache, jcache)
    jbare, _ = jm.prefill(jp, jnp.asarray(toks))
    bare, _ = tm.prefill(tp, torch.from_numpy(toks))
    _close(bare, jbare)
    moved = (last - bare).abs().amax(-1)
    assert float(moved[0]) > 1e-3
    if not tm.cfg.num_experts:
        assert float(moved[1]) < 1e-6


def test_qwen2_vl_mrope_sections_and_seq_lens_match_jax():
    """Three distinct M-RoPE rows (time, height, width of a patch grid)
    through the published sections (16, 24, 24) at hd 128, right padding,
    frames over both rows: 1e-5; the rows move the logits."""
    jcfg = _cut("qwen2-vl-72b")
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(1))
    tm = Model(ModelConfig(**dataclasses.asdict(jcfg)))
    tp = from_jax(jax.tree.map(np.asarray, jp), "cpu")
    b, s = 2, 18
    toks, mm = _inputs(jcfg, 5, b=b, s=s, frames=8)
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
@pytest.mark.parametrize("attn_impl", ["auto", "pallas"])
def test_engine_matches_jax_engine(models, attn_impl):
    """Both engines with the same ``attn_impl``: under "pallas" JAX runs its
    legacy decode and chunked-prefill kernels in interpret mode, the port
    the legacy kernel's plain version. Tokens, preemptions and per-iteration
    scheduling decisions equal."""
    rng = np.random.default_rng(0)
    vocab = models[0][0].cfg.vocab_size
    specs = [(_prompt(rng, vocab, n), 5, "OFFLINE", 0.0, None) for n in (13, 30)]
    specs.append((_prompt(rng, vocab, 21), 5, "ONLINE", 0.0, (10, 10)))
    _, teng, _, _ = _compare(models, specs, attn_impl=attn_impl, **ENGINE_KW)
    assert teng.runner.attn_impl == attn_impl


# ---------------------------------------------------------------- routing
@pytest.fixture(scope="module")
def scout_moe():
    jcfg = _cut(SCOUT)
    jp = jmoe.moe_init(jax.random.PRNGKey(2), jcfg, jnp.float32)
    return jcfg, jp, from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _route_input(jcfg, jp, rows, live):
    """x of ``rows`` + (d,) from the first numpy seed whose gates keep
    every token's choices ``MARGIN`` apart; padded rows copy row ``live``."""
    for seed in range(20):
        x = np.random.default_rng(seed).standard_normal(rows + (jcfg.d_model,))
        x = x.astype(np.float32)
        x[live:] = x[min(live, rows[0] - 1)]
        gates = np.array(jax.nn.softmax(
            jnp.asarray(x.reshape(-1, jcfg.d_model)) @ jp["router"], axis=-1))
        if _min_gap(gates) > MARGIN:
            return x, gates
    raise AssertionError(f"no input seed keeps the gates {MARGIN} apart")


@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_scout_route_matches_jax(scout_moe, case):
    """16 experts, top-1 at capacity factor 1.25: capacity 5 for the chunk
    group of 64, 1 for the decode batch of 8. ``dispatch`` exact, combine
    to 1e-6; at capacity 1 most choices are dropped, as in the reference."""
    jcfg, jp, _ = scout_moe
    rows, live = ROUTE_CASES[case]
    x, gates = _route_input(jcfg, jp, rows, live)
    t = rows[0] * rows[1]
    cap = max(int(np.ceil(t * jcfg.capacity_factor * jcfg.top_k / jcfg.num_experts)), 1)
    assert cap == {"chunk64": 5, "decode5pad8": 1}[case]
    g = gates.reshape(1, t, jcfg.num_experts)
    jd, jc = jmoe._route(jnp.asarray(g), jcfg.top_k, cap)
    d, c = moe._route(torch.from_numpy(g), jcfg.top_k, cap)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-6, atol=1e-6)
    kept = int(d.sum())
    assert kept <= min(t, jcfg.num_experts * cap)
    if case == "decode5pad8":       # the padded copies share one expert's slot
        assert kept < t


@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_scout_moe_apply_matches_jax(scout_moe, case):
    """The whole layer, routed experts and the shared expert, to 1e-5."""
    jcfg, jp, tp = scout_moe
    assert "shared" in tp and tuple(tp["we1"].shape) == (16, 256, 256)
    x, _ = _route_input(jcfg, jp, *ROUTE_CASES[case])
    want = jmoe.moe_apply(jp, jcfg, jnp.asarray(x))
    got = moe.moe_apply(tp, ModelConfig(**dataclasses.asdict(jcfg)), torch.from_numpy(x))
    _close(got, want)
