"""The port's training path against the JAX package on the CPU.

The same seeded inputs go to both packages, with the parameters carried
from the JAX init by ``params.from_jax``, in float32 (``tiny_cfg`` and the
reduced configs):
  - the schedule, the global norm and AdamW on the same gradients;
  - ``TokenStream``; ``forward_train``'s logits; the training walk's
    checkpointing and its split of the stacked weights;
  - one step of ``make_train_step`` on ``tiny_cfg`` and on one reduced
    config of each family (dense, MoE, SSM, hybrid, and multimodal with
    conditioning embeddings), and on recurrentgemma cut to 5 layers, whose
    checkpointed (rglru, rglru, attn) unit and unrolled pair both run:
    every leaf's gradient to rtol 1e-4 / atol 1e-6, the loss and the
    gradient norm to rtol 1e-5, the learning rate exactly, and each
    parameter's step within 0.1 lr of JAX's, entry by entry;
  - four steps at peak lr 3e-4 with warmup 1 on reduced mamba2 and
    recurrentgemma: the losses to rtol 1e-4 each step;
  - checkpoint files across the packages, and the training CLI.
"""
import dataclasses
import io
import os
import subprocess
import sys
import zipfile
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.training import adamw_init as jadamw_init  # noqa: E402
from repro.training import adamw_update as jadamw_update  # noqa: E402
from repro.training import checkpoint as jckpt  # noqa: E402
from repro.training import cosine_lr as jcosine_lr  # noqa: E402
from repro.training import loss_fn as jloss_fn  # noqa: E402
from repro.training import make_train_step as jmake_train_step  # noqa: E402
from repro.training.data import TokenStream as JTokenStream  # noqa: E402
from repro.training.optimizer import global_norm as jglobal_norm  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.params import from_jax, tree_leaves, tree_map, tree_unflatten  # noqa: E402
from repro_torch.training import (adamw_init, adamw_update, cosine_lr,  # noqa: E402
                                  make_train_step)
from repro_torch.training import checkpoint as ckpt  # noqa: E402
from repro_torch.training.data import TokenStream  # noqa: E402
from repro_torch.training.optimizer import global_norm  # noqa: E402
from repro_torch.training.train_step import loss_and_grads  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
LOSS_RTOL = 1e-5
STEP_LR = 0.1            # each parameter's step, in units of the step's lr
TRAJ_RTOL = 1e-4
BATCH, SEQ = 2, 32
FAMILIES = ["qwen3-4b", "qwen3-moe-30b-a3b", "mamba2-1.3b", "recurrentgemma-9b",
            "musicgen-medium"]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Beside five other test workers, one thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _pair(jcfg, seed=0):
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    m = Model(ModelConfig(**dataclasses.asdict(jcfg)))
    return jm, jp, m, from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _batches(cfg, n, seed=0):
    mm = cfg.mm_embed_dim if cfg.multimodal else None
    it = TokenStream(cfg.vocab_size, seed=seed).batches(BATCH, SEQ, mm)
    return [next(it) for _ in range(n)]


def _config(arch, tiny_cfg):
    if arch == "tiny":
        return tiny_cfg
    if arch == "recurrentgemma-9b-5-layers":
        return dataclasses.replace(jget_config("recurrentgemma-9b").reduced(), num_layers=5)
    return jget_config(arch).reduced()


def _steps_close(old, new, jold, jnew, lr, what):
    """Each parameter's step (new - old, elementwise) within STEP_LR x lr of
    JAX's."""
    for k, (a0, a1, b0, b1) in enumerate(zip(old, new, jold, jnew)):
        gap = np.abs((_np(a1) - _np(a0)).astype(np.float64)
                     - (np.asarray(b1, np.float64) - np.asarray(b0, np.float64)))
        bad = gap > STEP_LR * lr
        assert not bad.any(), (f"{what}: parameter {k}: {int(bad.sum())} entries, worst "
                               f"step gap {float((gap / lr).max()):.4f} lr")


def _grads_close(grads, jgrads, what):
    assert len(grads) == len(jgrads)
    for k, (g, w) in enumerate(zip(grads, jgrads)):
        np.testing.assert_allclose(_np(g), np.asarray(w, np.float32), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=f"{what}: gradient {k}")


def _jax_loss_and_grads(jm, jp, jb):
    return jax.jit(jax.value_and_grad(lambda q: jloss_fn(
        jm, q, jb["tokens"], jb["labels"], jb.get("mm_embeds"))))(jp)


# ------------------------------------------------------------ optimizer
@pytest.mark.parametrize("warmup,total", [(100, 10_000), (2, 8), (0, 8), (8, 8), (3, 5)])
def test_cosine_lr_matches(warmup, total):
    """Warmup steps to the bit; the cosine's steps to 1e-6 (numpy's float32
    cos against XLA's)."""
    for step in range(12):
        got = cosine_lr(step, peak=3e-4, warmup=warmup, total=total)
        want = float(jcosine_lr(jnp.int32(step), peak=3e-4, warmup=warmup, total=total))
        if step < warmup:
            assert got == want
        else:
            assert got == pytest.approx(want, rel=1e-6)


def _random_tree(rng, scale):
    return {"a": (rng.standard_normal((5, 7)) * scale).astype(np.float32),
            "layers": [({"w": (rng.standard_normal((3, 4, 6)) * scale).astype(np.float32),
                         "b": (rng.standard_normal((4,)) * scale).astype(np.float32)},)],
            "z": (rng.standard_normal((11,)) * scale).astype(np.float32)}


@pytest.mark.parametrize("gscale", [1e-2, 10.0], ids=["no-clip", "clip"])
def test_global_norm_and_adamw_update_match(gscale):
    """Given the same gradients, three AdamW steps of the port equal JAX's:
    the norm, m, v and the parameters to 1e-6 of each leaf's largest value."""
    rng = np.random.default_rng(3)
    pn = _random_tree(rng, 1.0)
    jp = jax.tree.map(jnp.asarray, pn)
    p = tree_map(lambda a: torch.from_numpy(a.copy()), pn)
    jopt, opt = jadamw_init(jp), adamw_init(p)

    def close(got, want, what):
        for k, (a, b) in enumerate(zip(tree_leaves(got), jax.tree.leaves(want))):
            b = np.asarray(b)
            np.testing.assert_allclose(_np(a), b, rtol=1e-6, atol=1e-6 * np.abs(b).max(),
                                       err_msg=f"{what} leaf {k}")
    for it in range(3):
        gn = _random_tree(rng, gscale)
        jg = jax.tree.map(jnp.asarray, gn)
        g = tree_map(torch.from_numpy, gn)
        assert float(global_norm(g)) == pytest.approx(float(jglobal_norm(jg)), rel=1e-6)
        jp, jopt, jgnorm = jadamw_update(jp, jg, jopt, lr=1e-2)
        p, opt, gnorm = adamw_update(p, g, opt, lr=1e-2)
        assert (float(gnorm) > 1.0) == (gscale > 1)
        assert float(gnorm) == pytest.approx(float(jgnorm), rel=1e-6)
        assert opt.step == int(jopt.step) == it + 1
        close(opt.m, jopt.m, f"m {it}")
        close(opt.v, jopt.v, f"v {it}")
        close(p, jp, f"params {it}")


def test_adamw_update_is_in_place_and_sliced(monkeypatch):
    """The update writes the tensors it was given, a slice of a leaf at a
    time, with the arithmetic of an unsliced update; so does the norm."""
    from repro_torch.training import optimizer
    rng = np.random.default_rng(4)
    pn = {"w": rng.standard_normal((3, 50)).astype(np.float32)}
    gn = {"w": rng.standard_normal((3, 50)).astype(np.float32)}
    whole = tree_map(lambda a: torch.from_numpy(a.copy()), pn)
    norm = global_norm(tree_map(torch.from_numpy, gn))
    adamw_update(whole, tree_map(torch.from_numpy, gn), adamw_init(whole), lr=1e-2)
    monkeypatch.setattr(optimizer, "SLICE", 16)
    torch.testing.assert_close(global_norm(tree_map(torch.from_numpy, gn)), norm)
    p = tree_map(lambda a: torch.from_numpy(a.copy()), pn)
    opt = adamw_init(p)
    ptr = p["w"].data_ptr()
    p2, opt2, _ = adamw_update(p, tree_map(torch.from_numpy, gn), opt, lr=1e-2)
    assert p2["w"].data_ptr() == ptr and opt2.m["w"] is opt.m["w"]
    torch.testing.assert_close(p2["w"], whole["w"], rtol=0, atol=0)


def test_token_stream_matches():
    for mm in (None, 64):
        a = TokenStream(512, seed=7).batches(3, 40, mm)
        b = JTokenStream(512, seed=7).batches(3, 40, mm)
        for _ in range(4):
            x, y = next(a), next(b)
            assert sorted(x) == sorted(y)
            for k in x:
                np.testing.assert_array_equal(x[k], y[k])


# ------------------------------------------------------------ the forward
def test_forward_train_logits_match(tiny_cfg):
    jm, jp, m, p = _pair(tiny_cfg)
    tok = np.random.default_rng(5).integers(0, tiny_cfg.vocab_size, (2, 24)).astype(np.int32)
    got = m.forward_train(p, torch.from_numpy(tok))
    want = np.asarray(jax.jit(jm.forward_train)(jp, jnp.asarray(tok)))
    assert tuple(got.shape) == (2, 24, tiny_cfg.vocab_size)
    np.testing.assert_allclose(_np(got), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("arch", ["tiny", "mamba2-1.3b", "recurrentgemma-9b-5-layers",
                                  "qwen3-moe-30b-a3b"])
def test_training_walk_leaves_gradients_unchanged(arch, tiny_cfg, monkeypatch):
    """``stack_context(train=True)`` recomputes each scan unit in the
    backward and splits the stacked leaves once: the gradients equal those
    of the serving walk, which indexes each layer, to the bit."""
    jcfg = _config(arch, tiny_cfg)
    _, _, m, p = _pair(jcfg)
    batch = {k: torch.from_numpy(v) for k, v in _batches(jcfg, 1)[0].items()}
    _, walk = loss_and_grads(m, p, batch)
    calls = []
    plain = tfm.stack_context

    def serving_walk(*a, train=False, **kw):
        calls.append(train)
        return plain(*a, train=False, **kw)
    monkeypatch.setattr(tfm, "stack_context", serving_walk)
    _, want = loss_and_grads(m, p, batch)
    assert calls == [True]
    for g, w in zip(walk, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def _leaf_consumers(root):
    """{id(leaf tensor): names of the graph nodes that read it directly}."""
    seen, todo, users = set(), [root], {}
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        for child, _ in fn.next_functions:
            if type(child).__name__ == "AccumulateGrad":
                users.setdefault(id(child.variable), []).append(type(fn).__name__)
            todo.append(child)
    return users


def test_training_walk_splits_each_stacked_leaf_once():
    """Each stacked leaf of a scan segment is read by one ``unbind`` (whose
    backward stacks its layers' gradients once) and by nothing else: no
    per-layer ``select``, each of whose backwards would write a zero tensor
    the size of the whole stack."""
    jcfg = dataclasses.replace(jget_config("mamba2-1.3b").reduced(), num_layers=3)
    _, _, m, p = _pair(jcfg)
    batch = _batches(jcfg, 1)[0]
    leaves = [t.detach().requires_grad_() for t in tree_leaves(p)]
    tree = tree_unflatten(p, leaves)
    users = _leaf_consumers(
        m.forward_train(tree, torch.from_numpy(batch["tokens"])).grad_fn)
    stacked = tree_leaves(tree["layers"][0])
    assert stacked and all(t.shape[0] == 3 for t in stacked)
    for t in stacked:
        assert users[id(t)] == ["UnbindBackward0"]


_ONE_STEP = {}


def _one_step(arch, tiny_cfg):
    """One step of both packages' train steps from the same weights and
    batch, at the default schedule (peak 3e-4, warmup 100); run once per
    config and shared by the tests below."""
    if arch in _ONE_STEP:
        return _ONE_STEP[arch]
    jcfg = _config(arch, tiny_cfg)
    jm, jp, m, p = _pair(jcfg)
    batch = _batches(jcfg, 1)[0]
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jloss, jgrads = _jax_loss_and_grads(jm, jp, jb)
    loss, grads = loss_and_grads(m, p, {k: torch.from_numpy(v) for k, v in batch.items()})
    old, jold = [t.clone() for t in tree_leaves(p)], jax.tree.leaves(jp)
    jp, jopt, jmet = jax.jit(jmake_train_step(jm))(jp, jadamw_init(jp), jb)
    p, opt, met = make_train_step(m, device="cpu")(p, adamw_init(p), batch)
    _ONE_STEP[arch] = out = dict(
        loss=loss, jloss=jloss, grads=grads, jgrads=jax.tree.leaves(jgrads), met=met,
        jmet=jmet, opt=opt, jopt=jopt, old=old, new=tree_leaves(p), jold=jold,
        jnew=jax.tree.leaves(jp))
    return out


STEP_ARCHS = ["tiny"] + FAMILIES + ["recurrentgemma-9b-5-layers"]


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_train_step_matches_jax(arch, tiny_cfg):
    """One step: every leaf's gradient, the loss, the gradient norm and the
    learning rate."""
    r = _one_step(arch, tiny_cfg)
    _grads_close(r["grads"], r["jgrads"], arch)
    assert float(r["loss"]) == pytest.approx(float(r["jloss"]), rel=LOSS_RTOL)
    met, jmet = r["met"], r["jmet"]
    assert float(met["loss"]) == pytest.approx(float(jmet["loss"]), rel=LOSS_RTOL)
    assert float(met["grad_norm"]) == pytest.approx(float(jmet["grad_norm"]), rel=LOSS_RTOL)
    assert met["lr"] == float(jmet["lr"])
    assert r["opt"].step == int(r["jopt"].step) == 1


# On one entry each of two configs the port's first step lies further than
# STEP_LR from JAX's. There the gradient cancels to float32 roundoff, near
# AdamW's eps, and the first update g / (|g| + eps) turns that roundoff into
# a large part of an lr. ``tools/step_gap.py`` prints the entries with the
# port's model run in float64; its readings are in the reasons.
_STEP_GAP = {
    "musicgen-medium": "layers[0][0]/attn/wk[0, 246, 3, 27] steps 0.1018 lr from JAX's: "
                       "clipped gradient port -1.163e-09, JAX -2.633e-11, float64 -2.635e-11; "
                       "the leaf's largest float32 roundoff is 3.70e-08 in the port and "
                       "3.55e-08 in JAX (tools/step_gap.py musicgen-medium)",
    "recurrentgemma-9b-5-layers": "layers[0][0]/rglru/wo[0, 73, 216] steps 0.5464 lr from "
                                  "JAX's: clipped gradient port -6.761e-09, JAX +1.661e-09, "
                                  "float64 -1.635e-09; the leaf's largest float32 roundoff is "
                                  "2.23e-07 in the port and 2.25e-07 in JAX "
                                  "(tools/step_gap.py recurrentgemma-9b --layers 5)"}


@pytest.mark.parametrize("arch", [
    pytest.param(a, marks=pytest.mark.xfail(
        strict=True, raises=AssertionError, reason=_STEP_GAP[a]))
    if a in _STEP_GAP else a for a in STEP_ARCHS])
def test_train_step_parameter_steps_match_jax(arch, tiny_cfg):
    """One step: each parameter's step within 0.1 lr of JAX's, entry by
    entry."""
    r = _one_step(arch, tiny_cfg)
    _steps_close(r["old"], r["new"], r["jold"], r["jnew"], r["met"]["lr"], arch)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "recurrentgemma-9b"])
def test_trajectory_at_peak_lr_matches_jax(arch):
    """Four steps at peak lr 3e-4 with warmup 1 (full lr from the first
    step) on the reduced config: the port's loss equals JAX's to 1e-4 at
    every step, wherever the schedule takes it."""
    jcfg = jget_config(arch).reduced()
    jm, jp, m, p = _pair(jcfg)
    jstep = jax.jit(jmake_train_step(jm, peak_lr=3e-4, warmup=1))
    step = make_train_step(m, peak_lr=3e-4, warmup=1, device="cpu")
    jopt, opt = jadamw_init(jp), adamw_init(p)
    got, want = [], []
    for batch in _batches(jcfg, 4):
        jp, jopt, jmet = jstep(jp, jopt, {k: jnp.asarray(v) for k, v in batch.items()})
        p, opt, met = step(p, opt, batch)
        want.append(float(jmet["loss"]))
        got.append(float(met["loss"]))
    np.testing.assert_allclose(got, want, rtol=TRAJ_RTOL)


# ------------------------------------------------------------ checkpoints
def test_checkpoint_round_trip(tiny_cfg, tmp_path):
    _, _, m, p = _pair(tiny_cfg)
    path = str(tmp_path / "sub" / "ck")
    ckpt.save(path, p, step=7)
    got, step = ckpt.restore(path, tree_map(torch.zeros_like, p))
    assert step == 7
    for a, b in zip(tree_leaves(got), tree_leaves(p)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="leaves"):
        ckpt.restore(path, {"x": torch.zeros(2)})


def test_jax_float32_checkpoint_restores_in_port(tiny_cfg, tmp_path):
    jm, jp, m, p = _pair(tiny_cfg)
    path = str(tmp_path / "ck")
    jckpt.save(path, jp, step=3)
    got, step = ckpt.restore(path, tree_map(torch.zeros_like, p))
    assert step == 3
    for a, b in zip(tree_leaves(got), jax.tree.leaves(jp)):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _bf16_tree():
    rng = np.random.default_rng(6)
    jtree = {"b": jnp.asarray(rng.standard_normal((3, 5)), jnp.bfloat16),
             "f": jnp.asarray(rng.standard_normal((4,)), jnp.float32),
             "s": [jnp.asarray(rng.standard_normal((2, 2, 3)), jnp.bfloat16)]}
    return jtree, from_jax(jax.tree.map(np.asarray, jtree), "cpu")


def test_jax_bf16_checkpoint_restores_as_bf16_bits(tmp_path):
    """JAX writes a bfloat16 leaf as raw 2-byte words (``|V2``); the port
    reads them back as the same bfloat16 bits."""
    jtree, tree = _bf16_tree()
    jckpt.save(str(tmp_path / "jax"), jtree, step=2)
    with np.load(tmp_path / "jax.npz") as data:
        assert data["leaf_0"].dtype.str == "|V2"
    got, step = ckpt.restore(str(tmp_path / "jax"), tree_map(torch.zeros_like, tree))
    assert step == 2 and got["b"].dtype == got["s"][0].dtype == torch.bfloat16
    for a, b in zip(tree_leaves(got), tree_leaves(tree)):
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
                           b.view(torch.int16) if b.dtype == torch.bfloat16 else b)


def test_port_bf16_checkpoint_is_jax_file_byte_for_byte(tmp_path):
    """The port writes every member of the file as the JAX package does,
    and restores its own bfloat16 file bit for bit."""
    jtree, tree = _bf16_tree()
    ckpt.save(str(tmp_path / "port"), tree, step=2)
    jckpt.save(str(tmp_path / "jax"), jtree, step=2)
    mine, theirs = zipfile.ZipFile(tmp_path / "port.npz"), zipfile.ZipFile(tmp_path / "jax.npz")
    assert mine.namelist() == theirs.namelist()
    for name in theirs.namelist():
        assert mine.read(name) == theirs.read(name), name
    assert np.load(io.BytesIO(mine.read("leaf_0.npy"))).dtype.str == "|V2"
    got, _ = ckpt.restore(str(tmp_path / "port"), tree_map(torch.zeros_like, tree))
    for a, b in zip(tree_leaves(got), tree_leaves(tree)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# ------------------------------------------------------------ the CLI
def _cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *args], capture_output=True,
        text=True, timeout=300, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1"))


def test_train_cli_on_cpu_saves_a_checkpoint(tmp_path):
    """``--device cpu`` trains the reduced config, prints the JAX CLI's
    lines and saves a file that restores into the model's tree."""
    path = str(tmp_path / "ck")
    out = _cli("--device", "cpu", "--arch", "mamba2-1.3b", "--steps", "2", "--batch", "1",
               "--seq", "32", "--save", path)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert [ln.split()[:2] for ln in lines[:2]] == [["step", "0"], ["step", "1"]]
    assert all("loss" in ln and "gnorm" in ln and "lr" in ln for ln in lines[:2])
    assert lines[-1] == f"saved checkpoint to {path}.npz"
    cfg = ModelConfig(**dataclasses.asdict(jget_config("mamba2-1.3b").reduced()))
    like = Model(cfg).init(torch.Generator().manual_seed(1))
    got, step = ckpt.restore(path, like)
    assert step == 2 and len(tree_leaves(got)) == len(tree_leaves(like))


def test_train_cli_defaults_to_the_card():
    """Without ``--device`` the CLI asks for the card, and raises on a
    machine without one."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = _cli("--steps", "1")
    assert out.returncode != 0 and "cuda" in out.stderr
