"""The multi-device layer on one CPU rank: a (data 1, model 1) ``DeviceMesh``
over a ``gloo`` process group of one, with the logical-axis hook installed.

On reduced mamba2-1.3b, recurrentgemma-9b cut to 5 layers, qwen3-4b and
qwen3-moe-30b-a3b in float32, with the weights carried from the JAX init
(``params.from_jax``): ``forward_train``'s logits, one ``make_train_step``
step with ZeRO-1 moments (loss, gradient norm, every updated parameter)
and ``prefill`` + ``pad_cache`` + ``decode_step`` logits on DTensors equal
the hook-free run on plain tensors bitwise, and JAX's at the parity
tests' tolerances (logits 1e-5 of their largest for the training forward
and 1e-4 for prefill and decode, loss and gradient norm rtol 1e-5).

Also: with an identity hook every one of the eight ``constrain`` sites is
reached and nothing changes (bitwise); the scans' shape-only ``meta``
route; and without a card a tensor of another device still raises.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch.distributed.tensor import DTensor  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.training import adamw_init as jadamw_init  # noqa: E402
from repro.training import make_train_step as jmake_train_step  # noqa: E402
from repro_torch.configs.base import InputShape, ModelConfig  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import rglru_scan as rglru_mod  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd_mod  # noqa: E402
from repro_torch.launch import sharding as sh  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import hooks  # noqa: E402
from repro_torch.params import from_jax, tree_leaves  # noqa: E402
from repro_torch.training import adamw_init, make_train_step  # noqa: E402
from repro_torch.training.data import TokenStream  # noqa: E402

ARCHS = ["mamba2-1.3b", "recurrentgemma-9b-5-layers", "qwen3-4b", "qwen3-moe-30b-a3b"]
BATCH, SEQ, PROMPT, TOTAL = 2, 32, 24, 28
LOSS_RTOL = 1e-5


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mesh():
    """A (data 1, model 1) mesh over a gloo group of one rank, torn down
    after the module: the workers run other files after this one."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield make_mesh((1, 1), ("data", "model"), device_type="cpu")
    finally:
        dist.destroy_process_group()


def _jcfg(arch):
    if arch == "recurrentgemma-9b-5-layers":
        return dataclasses.replace(jget_config("recurrentgemma-9b").reduced(), num_layers=5)
    return jget_config(arch).reduced()


def _full(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


def _np(t):
    return _full(t).detach().float().numpy()


def _run(model, params, batch, tokens, opt):
    """forward_train logits, one train step (loss, gradient norm, updated
    leaves), and prefill + pad_cache + decode logits."""
    with torch.no_grad():
        logits = model.forward_train(params, tokens)
    step = make_train_step(model, device="cpu")
    params, opt, met = step(params, opt, batch)
    out = dict(logits=_full(logits), loss=_full(met["loss"]), gnorm=_full(met["grad_norm"]),
               leaves=[_full(t).detach().clone() for t in tree_leaves(params)])
    with torch.no_grad():
        prompt = tokens[:, :PROMPT]
        last, cache = model.prefill(params, prompt)
        cache = model.pad_cache(cache, PROMPT, TOTAL)
        cur = torch.argmax(last, dim=-1)
        dec = []
        for pos in range(PROMPT, TOTAL):
            lg, cache = model.decode_step(params, cur, cache, _pos(cur, pos))
            dec.append(_full(lg))
            cur = torch.argmax(lg, dim=-1)
    out.update(prefill=_full(last), decode=dec)
    return out


def _pos(like, pos):
    p = torch.full((BATCH,), pos, dtype=torch.int32)
    if isinstance(like, DTensor):
        return DTensor.from_local(p, like.device_mesh, like.placements, run_check=False)
    return p


_RUNS = {}


def _runs(arch, mesh):
    """The plain run, the run on the mesh, and JAX's, cached per arch."""
    if arch in _RUNS:
        return _RUNS[arch]
    jcfg = _jcfg(arch)
    jm, jp = JModel(jcfg), JModel(jcfg).init(jax.random.PRNGKey(0))
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    m = Model(cfg)
    batch = next(TokenStream(cfg.vocab_size, seed=0).batches(BATCH, SEQ))
    tokens = torch.from_numpy(batch["tokens"])

    p = from_jax(jax.tree.map(np.asarray, jp), "cpu")
    plain = _run(m, p, batch, tokens, adamw_init(p))

    dp = sh.param_shardings(from_jax(jax.tree.map(np.asarray, jp), "cpu"), mesh)
    args, placements = sh.input_specs(cfg, InputShape("t", SEQ, BATCH, "train"), mesh)
    dbatch = sh.distribute({k: torch.from_numpy(v) for k, v in batch.items()},
                           placements, mesh)
    with sh.on_mesh(mesh):
        sharded = _run(m, dp, dbatch, dbatch["tokens"], sh.zero1_adamw_init(dp, mesh))

    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jlogits = jm.forward_train(jp, jb["tokens"])
    _, _, jmet = jax.jit(jmake_train_step(jm))(jp, jadamw_init(jp), jb)
    jlast, jcache = jm.prefill(jp, jb["tokens"][:, :PROMPT])
    ref = dict(logits=np.asarray(jlogits, np.float32), loss=float(jmet["loss"]),
               gnorm=float(jmet["grad_norm"]), prefill=np.asarray(jlast, np.float32))
    jcache = jm.pad_cache(jcache, PROMPT, TOTAL)
    cur, jdec = jnp.argmax(jlast, axis=-1).astype(jnp.int32), []
    for pos in range(PROMPT, TOTAL):
        jlg, jcache = jm.decode_step(jp, cur, jcache, jnp.full((BATCH,), pos, jnp.int32))
        jdec.append(np.asarray(jlg, np.float32))
        cur = jnp.argmax(jlg, axis=-1).astype(jnp.int32)
    ref["decode"] = jdec
    _RUNS[arch] = out = (plain, sharded, ref)
    return out


def _close(got, want, rtol):
    got = _np(got)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_on_the_mesh(arch, mesh):
    plain, sharded, ref = _runs(arch, mesh)
    assert torch.equal(sharded["logits"], plain["logits"])
    _close(plain["logits"], ref["logits"], 1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_on_the_mesh(arch, mesh):
    """One step with ZeRO-1 moments: loss, gradient norm and every updated
    parameter bitwise the plain step's; loss and norm JAX's to 1e-5."""
    plain, sharded, ref = _runs(arch, mesh)
    assert torch.equal(sharded["loss"], plain["loss"])
    assert torch.equal(sharded["gnorm"], plain["gnorm"])
    assert len(sharded["leaves"]) == len(plain["leaves"])
    for k, (a, b) in enumerate(zip(sharded["leaves"], plain["leaves"])):
        assert torch.equal(a, b), f"parameter {k}"
    assert float(plain["loss"]) == pytest.approx(ref["loss"], rel=LOSS_RTOL)
    assert float(plain["gnorm"]) == pytest.approx(ref["gnorm"], rel=LOSS_RTOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_on_the_mesh(arch, mesh):
    """After the step: prefill, pad_cache and greedy decode steps."""
    plain, sharded, ref = _runs(arch, mesh)
    assert torch.equal(sharded["prefill"], plain["prefill"])
    for a, b in zip(sharded["decode"], plain["decode"]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch):
    """The hook-free prefill and decode against JAX on the initial weights
    (the runs above step the weights first)."""
    jcfg = _jcfg(arch)
    jm, jp = JModel(jcfg), JModel(jcfg).init(jax.random.PRNGKey(0))
    m = Model(ModelConfig(**dataclasses.asdict(jcfg)))
    p = from_jax(jax.tree.map(np.asarray, jp), "cpu")
    toks = np.random.default_rng(0).integers(0, jcfg.vocab_size, (BATCH, PROMPT), np.int32)
    jlast, jcache = jm.prefill(jp, jnp.asarray(toks))
    with torch.no_grad():
        last, cache = m.prefill(p, torch.from_numpy(toks))
    _close(last, np.asarray(jlast, np.float32), 1e-4)
    jcache, cache = jm.pad_cache(jcache, PROMPT, TOTAL), m.pad_cache(cache, PROMPT, TOTAL)
    cur = np.argmax(np.asarray(jlast), axis=-1).astype(np.int32)
    for pos in range(PROMPT, TOTAL):
        jlg, jcache = jm.decode_step(jp, jnp.asarray(cur), jcache,
                                     jnp.full((BATCH,), pos, jnp.int32))
        with torch.no_grad():
            lg, cache = m.decode_step(p, torch.from_numpy(cur), cache,
                                      torch.full((BATCH,), pos, dtype=torch.int32))
        _close(lg, np.asarray(jlg, np.float32), 1e-4)
        cur = np.argmax(np.asarray(jlg), axis=-1).astype(np.int32)


# the eight constrain sites of the JAX models, by their logical axes
SITES = {
    ("batch", None, None),                      # _embed; moe xg
    ("batch", None, "vocab"),                   # _logits
    ("batch", "seq_fallback", "heads", None),   # attention q
    ("batch", None, "kv_heads", None),          # attention k, v
    ("batch", None, "heads", None),             # ssm x_in
    ("experts", "batch", None, None),           # moe expert_in
}


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "mamba2-1.3b"])
def test_identity_hook_reaches_every_site_and_changes_nothing(arch):
    """A hook that records and returns its input: the outputs are bitwise
    those without a hook, and the model passes through its sites."""
    m = Model(ModelConfig(**dataclasses.asdict(_jcfg(arch))))
    p = m.init(torch.Generator().manual_seed(0))
    toks = torch.randint(0, m.cfg.vocab_size, (BATCH, SEQ),
                         generator=torch.Generator().manual_seed(1))

    def outputs():
        with torch.no_grad():
            last, cache = m.prefill(p, toks)
            lg, _ = m.decode_step(p, toks[:, -1], m.pad_cache(cache, SEQ, SEQ + 2),
                                  torch.full((BATCH,), SEQ, dtype=torch.int32))
            return [m.forward_train(p, toks), last, lg]
    want = outputs()
    seen = []
    hooks.set_hook(lambda x, axes: seen.append(tuple(axes)) or x)
    try:
        got = outputs()
    finally:
        hooks.clear_hook()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    expect = {("batch", None, None), ("batch", None, "vocab")}
    expect |= ({("batch", None, "heads", None)} if arch == "mamba2-1.3b" else
               {("batch", "seq_fallback", "heads", None), ("batch", None, "kv_heads", None),
                ("experts", "batch", None, None)})
    assert expect <= set(seen) <= SITES


# ------------------------------------------------------------ the scans
@pytest.mark.parametrize("grad", [False, True])
def test_scans_meta_route_gives_the_kernels_shapes(grad):
    """``meta`` tensors: empty outputs of the kernels' shapes and dtypes,
    forward and backward, and their operations counted; nothing computed."""
    meta = dict(device="meta")
    b, s, h, p, n, chunk = 2, 128, 4, 16, 8, 32
    x = torch.empty((b, s, h, p), **meta, requires_grad=grad)
    dta = torch.empty((b, s, h), **meta)
    bm = torch.empty((b, s, n), dtype=torch.bfloat16, **meta)
    ssd_mod.ssd_scan.meta_flops = 0
    y, final = ops.ssd_scan(x, dta, bm, bm, chunk=chunk)
    assert (y.shape, y.dtype, final.shape, final.dtype) == (
        (b, s, h, p), torch.float32, (b, h, p, n), torch.float32)
    assert ssd_mod.ssd_scan.meta_flops == ssd_mod.ssd_fwd_flops(b, s, h, p, n, chunk)
    _, _, states = ssd_mod.ssd_scan(x, dta, bm, bm, chunk=chunk, return_all_states=True)
    assert tuple(states.shape) == (b, s // chunk, h, p, n)
    grads = ssd_mod.ssd_scan_bwd(x, dta, bm, bm, chunk, states, y, final)
    assert [tuple(g.shape) for g in grads] == [(b, s, h, p), (b, s, h), (b, s, n), (b, s, n)]
    assert all(g.dtype == torch.float32 and g.device.type == "meta" for g in grads)
    a = torch.empty((b, s, 64), dtype=torch.bfloat16, **meta, requires_grad=grad)
    hh = ops.rglru_scan(a, a)
    assert (hh.shape, hh.dtype, hh.device.type) == (a.shape, torch.float32, "meta")
    da, db = rglru_mod.rglru_scan_bwd(a, hh, hh)
    assert da.shape == db.shape == a.shape and da.dtype == db.dtype == torch.bfloat16
    if grad:
        (y.sum() + final.sum() + hh.sum()).backward()
        assert x.grad.shape == x.shape and a.grad.shape == a.shape
    with pytest.raises(ValueError):
        ops.ssd_scan(x, dta, bm, bm, chunk=48)          # S not a chunk multiple


def test_other_device_still_raises(monkeypatch, tmp_path):
    """Without a card, a tensor of another device than the CPU and meta
    reaches neither a plain version nor the meta route: a CUDA tensor
    raises for want of a kernel, another device raises outright."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.kernels import build

    def missing():
        raise RuntimeError("nvcc not found")
    monkeypatch.setattr(build, "_nvcc", missing)
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(build, "_fns", {})
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(ssd_mod, "ssd_chunked", None)
    monkeypatch.setattr(rglru_mod, "ref_rglru_scan", None)
    with FakeTensorMode():
        x = torch.empty((1, 64, 4, 16), device="cuda")
        dta = torch.empty((1, 64, 4), device="cuda")
        bm = torch.empty((1, 64, 8), device="cuda")
        a = torch.empty((1, 37, 64), device="cuda")
        with pytest.raises(RuntimeError, match="nvcc"):
            ops.ssd_scan(x, dta, bm, bm, chunk=16)
        with pytest.raises(RuntimeError, match="nvcc"):
            ops.rglru_scan(a, a)
    fake = type("Other", (), {"device": torch.device("xpu")})()
    with pytest.raises(ValueError, match="no SSD scan for device"):
        ssd_mod.ssd_scan(fake, None, None, None, chunk=16)
    with pytest.raises(ValueError, match="no RG-LRU scan for device"):
        rglru_mod.rglru_scan(fake, None)
