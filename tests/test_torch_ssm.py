"""The port's SSD scan (plain versions), SSM layer and SSM model pieces
against the JAX package: the Pallas ``ssd_scan`` in interpret mode, the
sequential oracle and ``ssd_chunked`` on the cases of tests/test_kernels.py,
``ssm_context`` / ``ssm_decode`` / ``Model.decode_step`` / ``make_cache`` on
mamba2-1.3b reduced, and the full-width state sizes. Inputs come from numpy
with a seed, parameters from the JAX init through ``from_jax``; float32 with
the JAX sweep's tolerance, 2e-4."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core.block_io import io_spec_for_model as jio_spec  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan as pallas_ssd  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.core.block_io import io_spec_for_model  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd_mod  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.params import from_jax, tree_leaves  # noqa: E402

TOL = 2e-4
# (b, s, h, p, n, chunk): the SSD sweep of tests/test_kernels.py
SSD_CASES = [(2, 64, 2, 8, 4, 16), (1, 128, 4, 16, 8, 32), (3, 32, 1, 4, 16, 16)]


def _close(got, want, tol=TOL):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol, atol=tol)


def _ssd_inputs(case, seed, slow=False, with_init=False):
    """numpy draws for both packages; ``slow`` makes dt_a ~ -0.01 softplus,
    so the carried and initial state dominate y."""
    b, s, h, p, n, _ = case
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p), np.float32)
    sp = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    dta = -(0.01 if slow else 1.0) * sp
    bm = rng.standard_normal((b, s, n), np.float32)
    cm = rng.standard_normal((b, s, n), np.float32)
    init = rng.standard_normal((b, h, p, n), np.float32) if with_init else None
    return x, dta, bm, cm, init


def _t(a):
    return None if a is None else torch.from_numpy(a)


@pytest.mark.parametrize("case", SSD_CASES)
def test_plain_ssd_scan_matches_pallas_interpret(case):
    x, dta, bm, cm, _ = _ssd_inputs(case, seed=case[1] + case[2])
    chunk = case[-1]
    y, fs = ssd_mod.ssd_scan(_t(x), _t(dta), _t(bm), _t(cm), chunk=chunk)
    jy, jfs = pallas_ssd(jnp.asarray(x), jnp.asarray(dta), jnp.asarray(bm),
                         jnp.asarray(cm), chunk=chunk, interpret=True)
    assert y.dtype == torch.float32 and tuple(fs.shape) == jfs.shape
    _close(y, jy)
    _close(fs, jfs)


@pytest.mark.parametrize("slow", [False, True], ids=["decay", "slow-decay"])
@pytest.mark.parametrize("case", SSD_CASES)
def test_plain_ssd_scan_matches_sequential_oracle(case, slow):
    """The port's chunked scan and its sequential oracle against the JAX
    oracle, from a random initial state."""
    x, dta, bm, cm, init = _ssd_inputs(case, seed=7, slow=slow, with_init=True)
    jy, jfs = jref.ref_ssd_sequential(*(jnp.asarray(a) for a in (x, dta, bm, cm)),
                                      initial_state=jnp.asarray(init))
    y, fs = ssd_mod.ssd_scan(_t(x), _t(dta), _t(bm), _t(cm), chunk=case[-1],
                             initial_state=_t(init))
    _close(y, jy)
    _close(fs, jfs)
    ry, rfs = ref.ref_ssd_sequential(_t(x), _t(dta), _t(bm), _t(cm),
                                     initial_state=_t(init))
    _close(ry, jy)
    _close(rfs, jfs)


@pytest.mark.parametrize("with_init", [False, True], ids=["zero-init", "init"])
@pytest.mark.parametrize("case", SSD_CASES)
def test_plain_ssd_scan_states_match_jax_ssd_chunked(case, with_init):
    x, dta, bm, cm, init = _ssd_inputs(case, seed=11, with_init=with_init)
    chunk = case[-1]
    jy, jfs, jst = jssm.ssd_chunked(
        *(jnp.asarray(a) for a in (x, dta, bm, cm)), chunk,
        initial_state=None if init is None else jnp.asarray(init),
        return_all_states=True)
    y, fs, st = ops.ssd_scan(_t(x), _t(dta), _t(bm), _t(cm), chunk=chunk,
                             initial_state=_t(init), return_all_states=True)
    assert tuple(st.shape) == jst.shape == (case[0], case[1] // chunk) + fs.shape[1:]
    _close(y, jy)
    _close(fs, jfs)
    _close(st, jst)
    torch.testing.assert_close(st[:, -1], fs)


def test_plain_version_counts_no_launch():
    before = ssd_mod.ssd_scan.launches, ssd_mod.ssd_chunked.cuda_calls
    x, dta, bm, cm, _ = _ssd_inputs(SSD_CASES[0], seed=0)
    ssd_mod.ssd_scan(_t(x), _t(dta), _t(bm), _t(cm), chunk=16)
    assert (ssd_mod.ssd_scan.launches, ssd_mod.ssd_chunked.cuda_calls) == before


@pytest.mark.parametrize("b,h,p,sms,want", [
    (1, 64, 64, 132, 32),    # mamba2-1.3b at batch 1: 128 CTAs; 16 rows need 256
    (1, 32, 64, 132, 16),    # 128 CTAs of 16 rows still fit one wave
    (1, 33, 64, 132, 16),    # exactly one CTA an SM
    (1, 34, 64, 132, 32),    # one CTA past the wave: back to 32 rows
    (8, 64, 64, 132, 32),    # never wider than 32 rows, a cluster of 2 a head
    (2, 2, 8, 132, 16),      # P below 16: one CTA a head, padded with zeros
    (1, 4, 16, 132, 16),     # P 16: one CTA a head
    (1, 8, 64, 8, 32),       # a card of 8 SMs: 32 rows already fill it
])
def test_p_slice_fills_one_wave(b, h, p, sms, want):
    assert ssd_mod.p_slice(b, h, p, sms) == want


# ---------------------------------------------------------------- the layer
@pytest.fixture(scope="module")
def mamba():
    jcfg = jget_config("mamba2-1.3b").reduced()
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(ModelConfig(**dataclasses.asdict(jcfg)))
    tp = from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, jm, jp, tm, tp


def _layer(params, i=0):
    """Layer i's ssm parameters, from either package's stacked tree."""
    (blocks,) = params["layers"][0]
    return {k: v[i] for k, v in blocks["ssm"].items()}


def _random_initial(cfg, rng):
    d_inner, nheads = ssm.ssm_dims(cfg)
    conv = rng.standard_normal((1, cfg.ssm_conv, d_inner + 2 * cfg.ssm_state),
                               np.float32)
    ssd = rng.standard_normal((1, nheads, cfg.ssm_head_dim, cfg.ssm_state),
                              np.float32)
    return {"conv": conv, "ssd": ssd}


@pytest.mark.parametrize("s,resume,bounds", [
    (32, False, False),      # plain prefill
    (37, False, False),      # S not a chunk multiple: padded with dt = 0
    (37, True, False),       # resume from a state, padded
    (48, True, True),        # resume and capture every chunk boundary
    (32, False, True),
])
def test_ssm_context_matches_jax(mamba, s, resume, bounds):
    cfg, _, jp, _, tp = mamba
    rng = np.random.default_rng(s + 3 * resume)
    x = rng.standard_normal((1, s, cfg.d_model), np.float32)
    init = _random_initial(cfg, rng) if resume else None
    kw = dict(return_cache=True, boundary_states=bounds)
    jout = jssm.ssm_context(_layer(jp), cfg, jnp.asarray(x),
                            initial=None if init is None else
                            jax.tree.map(jnp.asarray, init), **kw)
    tout = ssm.ssm_context(_layer(tp), cfg, torch.from_numpy(x),
                           initial=None if init is None else
                           {k: torch.from_numpy(v) for k, v in init.items()}, **kw)
    _close(tout[0], jout[0])
    for k in ("conv", "ssd"):
        _close(tout[1][k], jout[1][k])
    if bounds:
        assert tout[2]["ssd"].shape[1] == s // cfg.ssm_chunk
        for k in ("conv", "ssd"):
            _close(tout[2][k], jout[2][k])


def test_ssm_decode_matches_jax(mamba):
    cfg, _, jp, _, tp = mamba
    rng = np.random.default_rng(5)
    cache = _random_initial(cfg, rng)
    jc = jax.tree.map(jnp.asarray, cache)
    tc = {k: torch.from_numpy(v) for k, v in cache.items()}
    for _ in range(3):
        x = rng.standard_normal((1, 1, cfg.d_model), np.float32)
        jo, jc = jssm.ssm_decode(_layer(jp, 1), cfg, jnp.asarray(x), jc)
        to, tc = ssm.ssm_decode(_layer(tp, 1), cfg, torch.from_numpy(x), tc)
        _close(to, jo)
        for k in ("conv", "ssd"):
            _close(tc[k], jc[k])


def test_model_decode_step_and_make_cache_match_jax(mamba):
    cfg, jm, jp, tm, tp = mamba
    jc = jm.make_cache(1, 1)
    tc = tm.make_cache(1, 1, device="cpu")
    assert [jax.tree.map(lambda a: (a.shape, str(a.dtype)), s) for s in jc] == \
        [tuple({k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
                for k, v in d.items()} for d in s) for s in tc]
    assert all(float(t.abs().sum()) == 0 for t in tree_leaves(tc))
    rng = np.random.default_rng(9)
    for pos, tok in enumerate(rng.integers(0, cfg.vocab_size, 5)):
        jl, jc = jm.decode_step(jp, jnp.asarray([tok], jnp.int32), jc,
                                jnp.asarray([pos], jnp.int32))
        tl, tc = tm.decode_step(tp, torch.tensor([int(tok)]), tc,
                                torch.tensor([pos]))
        _close(tl, jl)
    for j, t in zip(jax.tree.leaves(jc), tree_leaves(tc)):
        _close(t, j)


def test_make_cache_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        Model(get_config("mamba2-1.3b").reduced()).make_cache(1, 1)


def test_full_width_state_sizes_match_jax():
    """cache_bytes and the block I/O spec of full-width mamba2-1.3b, from
    specs alone (meta tensors: nothing is allocated)."""
    jm = JModel(jget_config("mamba2-1.3b"))
    tm = Model(get_config("mamba2-1.3b"))
    assert tm.cache_bytes(1, 1) == jm.cache_bytes(1, 1) == 102_334_464
    assert all(t.device.type == "meta"
               for t in tree_leaves(tm.make_cache(1, 1, as_specs=True)))
    spec, jspec = io_spec_for_model(tm), jio_spec(jm)
    assert spec.family == jspec.family == "state" and spec.restore_last_only
    assert spec.block_bytes(64) == jspec.block_bytes(64) == tm.cache_bytes(1, 1)
    assert spec.restore_bytes(256, 64) == jspec.restore_bytes(256, 64)


def test_from_jax_carries_ssm_tree_of_bf16_model():
    """A bf16 model's ssm tree crosses with its float32 A_log, D and
    dt_bias and every other leaf in bfloat16, bit for bit."""
    jcfg = dataclasses.replace(jget_config("mamba2-1.3b").reduced(), dtype="bfloat16")
    jp = JModel(jcfg).init(jax.random.PRNGKey(1))
    np_params = jax.tree.map(np.asarray, jp)
    tp = from_jax(np_params, "cpu")
    (blocks,) = tp["layers"][0]
    (jblocks,) = np_params["layers"][0]
    assert set(blocks["ssm"]) == set(jblocks["ssm"])
    for k, v in blocks["ssm"].items():
        want = torch.float32 if k in ("A_log", "D", "dt_bias") else torch.bfloat16
        assert v.dtype == want, k
        assert tuple(v.shape) == jblocks["ssm"][k].shape
        np.testing.assert_array_equal(v.float().numpy(),
                                      jblocks["ssm"][k].astype(np.float32))
    assert blocks["ln"].dtype == torch.bfloat16
