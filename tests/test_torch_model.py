"""The port's model pieces against the JAX package: common ops, the
parameter bridge, the init layout, and the paged runner's logits and page
writes (float32, 1e-4) on tiny_cfg and qwen3-4b reduced."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core  # noqa: E402,F401  (package import order: core before models.paged)
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models.paged import PagedRunner  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import common  # noqa: E402
from repro_torch.models.paged import TorchPagedRunner  # noqa: E402
from repro_torch.params import from_jax, tree_leaves  # noqa: E402


def _port_cfg(jcfg):
    return ModelConfig(**dataclasses.asdict(jcfg))


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


# ---------------------------------------------------------------- common ops
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64), np.float32) * 3
    s = rng.standard_normal((64,), np.float32)
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    got = common.rms_norm(torch.from_numpy(x).to(tdt), torch.from_numpy(s).to(tdt), 1e-6)
    want = jcommon.rms_norm(jnp.asarray(x, jdt), jnp.asarray(s, jdt), 1e-6)
    assert got.dtype == tdt
    tol = 1e-2 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("mrope", [(), (8, 4, 4)])
def test_rope_angles_and_apply_match(mrope):
    rng = np.random.default_rng(1)
    hd = 32
    if mrope:
        pos = rng.integers(0, 500, (3, 2, 7)).astype(np.int32)
    else:
        pos = rng.integers(0, 5000, (2, 7)).astype(np.int32)
    cos, sin = common.rope_angles(torch.from_numpy(pos), hd, 1e6, mrope)
    jcos, jsin = jcommon.rope_angles(jnp.asarray(pos), hd, 1e6, mrope)
    np.testing.assert_allclose(_np(cos), _np(jcos), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(sin), _np(jsin), rtol=1e-5, atol=1e-5)
    x = rng.standard_normal((2, 7, 4, hd), np.float32)
    got = common.apply_rope(torch.from_numpy(x), cos, sin)
    want = jcommon.apply_rope(jnp.asarray(x), jcos, jsin)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)


def test_swiglu_matches():
    rng = np.random.default_rng(2)
    p = {k: rng.standard_normal(s, np.float32) * 0.1
         for k, s in (("w1", (32, 48)), ("w3", (32, 48)), ("w2", (48, 32)))}
    x = rng.standard_normal((3, 32), np.float32)
    got = common.swiglu({k: torch.from_numpy(v) for k, v in p.items()},
                        torch.from_numpy(x))
    want = jcommon.swiglu({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)


def test_resolve_device_never_falls_back():
    assert common.resolve_device("cpu").type == "cpu"
    with pytest.raises(ValueError):
        common.resolve_device("meta")


# ---------------------------------------------------------------- params
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_from_jax_keeps_structure_shapes_and_dtypes(tiny_cfg, dtype):
    jcfg = dataclasses.replace(tiny_cfg, dtype=dtype)
    params = JModel(jcfg).init(jax.random.PRNGKey(3))
    tp = from_jax(jax.tree.map(np.asarray, params), "cpu")
    jleaves, jdef = jax.tree.flatten(params)
    tleaves = tree_leaves(tp)
    assert len(tleaves) == len(jleaves)
    assert isinstance(tp["layers"], list) and isinstance(tp["layers"][0], tuple)
    want_dt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    for a, t in zip(jleaves, tleaves):
        assert tuple(t.shape) == a.shape and t.dtype == want_dt
        np.testing.assert_array_equal(_np(t), np.asarray(a, np.float32))


NEW_ARCHS = ["yi-9b", "codeqwen1.5-7b", "granite-34b", "qwen3-moe-30b-a3b"]


@pytest.mark.parametrize("arch", ["tiny", "qwen3-4b"] + NEW_ARCHS)
def test_init_layout_and_scale_match_jax(tiny_cfg, arch):
    jcfg = tiny_cfg if arch == "tiny" else jget_config(arch).reduced()
    cfg = _port_cfg(jcfg)
    if arch != "tiny":
        assert cfg == get_config(arch).reduced()
        assert dataclasses.asdict(get_config(arch)) == \
            dataclasses.asdict(jget_config(arch))
    jparams = JModel(jcfg).init(jax.random.PRNGKey(0))
    tparams = Model(cfg).init(torch.Generator().manual_seed(0))
    jleaves = jax.tree.leaves(jparams)
    tleaves = tree_leaves(tparams)
    assert [a.shape for a in jleaves] == [tuple(t.shape) for t in tleaves]
    for a, t in zip(jleaves, tleaves):
        a = np.asarray(a, np.float32)
        t = _np(t)
        if a.std() == 0:                       # norms: ones
            np.testing.assert_array_equal(t, a)
        else:                                  # same normal scale
            assert abs(t.std() / a.std() - 1) < 0.1


def test_stacked_init_draws_one_layer_at_a_time(monkeypatch):
    """A stacked weight is drawn layer by layer in float32 and written into
    the target dtype: no float32 draw spans the layer axis, each layer has
    the reference's scale, and the layers differ."""
    shapes = []
    randn = torch.randn

    def spy(*args, **kw):
        shapes.append(tuple(args[0]))
        return randn(*args, **kw)
    monkeypatch.setattr(torch, "randn", spy)
    w = common.dense_init(torch.Generator().manual_seed(0), (64, 48), 64,
                          torch.bfloat16, lead=(3,))
    assert w.shape == (3, 64, 48) and w.dtype == torch.bfloat16
    assert shapes == [(64, 48)] * 3
    for layer in range(3):
        assert abs(float(w[layer].float().std()) * 8 - 1) < 0.1
    assert not torch.equal(w[0], w[1])
    shapes.clear()
    Model(_port_cfg(jget_config("qwen3-moe-30b-a3b").reduced())).init(
        torch.Generator().manual_seed(0))
    assert (4, 256, 512) in shapes                 # one layer's experts
    assert not any(len(s) == 4 for s in shapes)    # never the whole stack


# ---------------------------------------------------------------- runner
RUNNER_ARCHS = {"qwen3-moe": ("qwen3-moe-30b-a3b", 8.0),
                "qwen3-moe-cf0.5": ("qwen3-moe-30b-a3b", 0.5),
                "yi-9b": ("yi-9b", None), "codeqwen1.5-7b": ("codeqwen1.5-7b", None),
                "granite-34b": ("granite-34b", None)}


@pytest.fixture(scope="module", params=["tiny", "qwen3-4b"] + list(RUNNER_ARCHS))
def runners(request, tiny_cfg):
    """The MoE cases pad the decode batch of 3 to 4 rows, and the padded
    row routes with the live ones; at capacity factor 0.5 it takes
    capacity."""
    if request.param == "tiny":
        jcfg = tiny_cfg
    elif request.param == "qwen3-4b":
        jcfg = jget_config("qwen3-4b").reduced()
    else:
        arch, cf = RUNNER_ARCHS[request.param]
        jcfg = jget_config(arch).reduced()
        if cf is not None:
            jcfg = dataclasses.replace(jcfg, capacity_factor=cf)
    jm = JModel(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    tp = from_jax(jax.tree.map(np.asarray, params), "cpu")
    jr = PagedRunner(jm, params, num_pages=16, page_size=8,
                     max_pages_per_seq=8, chunk_size=16, attn_impl="ref")
    tr = TorchPagedRunner(Model(_port_cfg(jcfg)), tp, num_pages=16,
                          page_size=8, max_pages_per_seq=8, chunk_size=16,
                          device="cpu")
    return jr, tr


def _assert_pages_equal(jr, tr, atol=1e-4):
    for sj, st in zip(jr.pages, tr.pages):
        for pj, pt in zip(sj, st):
            for name in ("k", "v"):
                np.testing.assert_allclose(_np(pt[name]), np.asarray(pj[name]),
                                           rtol=1e-4, atol=atol)


def test_runner_prefill_and_decode_logits_match(runners):
    jr, tr = runners
    vocab = jr.model.cfg.vocab_size
    rng = np.random.default_rng(4)
    a = [int(x) for x in rng.integers(0, vocab, 21)]
    b = [int(x) for x in rng.integers(0, vocab, 9)]
    steps = [("prefill_chunk", (a[:16], 0, [3, 5, 7])),    # full chunk
             ("prefill_chunk", (a[16:], 16, [3, 5, 7])),    # ragged, at ctx 16
             ("prefill_chunk", (b, 0, [9, 2])),             # second request
             ("decode", ([5, 7], [[3, 5, 7], [9, 2]], [21, 9])),
             ("decode", ([1, 2, 3], [[3, 5, 7], [9, 2], [11]], [22, 10, 0]))]
    for method, args in steps:
        got = getattr(tr, method)(*args)
        want = getattr(jr, method)(*args)
        assert got.dtype == np.float32 and got.shape == np.asarray(want).shape
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   rtol=1e-4, atol=1e-4)
    _assert_pages_equal(jr, tr)


def test_runner_block_io_roundtrip_and_cross_payload(runners):
    """Swap round trip is bit-exact, and a JAX payload restores into the
    port's pool (float32 payloads move between the backends unchanged)."""
    jr, tr = runners
    toks = list(range(16))
    jr.prefill_chunk(toks, 0, [1, 2])
    tr.prefill_chunk(toks, 0, [1, 2])
    before = [t.clone() for t in tree_leaves(tr.pages)]
    payload = tr.read_block(1)
    assert [a.shape for a in tree_leaves(payload)] == \
        [np.asarray(a).shape for a in jax.tree.leaves(jr.read_block(1))]
    zeros = [[{k: np.zeros_like(v) for k, v in pg.items()} for pg in seg]
             for seg in payload]
    tr.write_block(1, zeros)
    assert any(not torch.equal(a, b) for a, b in zip(before, tree_leaves(tr.pages)))
    tr.write_block(1, payload)
    assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves(tr.pages)))
    tr.write_block(1, zeros)
    tr.write_block_lazy(1, jr.read_block(1))
    _assert_pages_equal(jr, tr)
    assert tr.bytes_per_block(8) == jr.bytes_per_block(8)


def test_runner_bfloat16_payload_roundtrip(tiny_cfg):
    cfg = _port_cfg(dataclasses.replace(tiny_cfg, dtype="bfloat16"))
    m = Model(cfg)
    tr = TorchPagedRunner(m, m.init(torch.Generator().manual_seed(1)),
                          num_pages=8, page_size=8, max_pages_per_seq=4,
                          chunk_size=16, device="cpu")
    tr.prefill_chunk(list(range(12)), 0, [2, 3])
    before = [t.clone() for t in tree_leaves(tr.pages)]
    payload = tr.read_block(2)
    assert all(a.dtype == np.uint16 for a in tree_leaves(payload))
    tr.write_block(2, [[{k: np.zeros_like(v) for k, v in pg.items()} for pg in seg]
                       for seg in payload])
    tr.write_block(2, payload)
    assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves(tr.pages)))
