"""ZeRO-1 on four CPU ranks, and the checkpoint of a mesh's training state.

A (data 2, model 2) ``DeviceMesh`` over four ``gloo`` processes on
localhost (their own 120 s limit, a free port) takes one training step of
reduced qwen3-4b (float32) with ZeRO-1 moments, which split the `model`
shard of w1, wq, embed and the like further over the data ranks. Against
the unsharded step on the same weights and batch (the step
tests/test_torch_training.py holds against JAX):
  - loss, gradient norm and every updated parameter within rtol 1e-5 and
    atol 1e-6, and the moments' ``full_tensor()`` too;
  - each rank's local moment is, exactly, the block of the global moment
    that JAX's spec gives the rank (``repro.launch.sharding``'s spec, its
    axes major first), and that block of the plain step's moment within
    the same tolerance.

The mesh's state (parameters and moments) saved through
``repro_torch.training.checkpoint`` is, member for member, byte for byte,
the JAX package's save of the same global arrays, and within the
tolerance the save of the plain step's; restored into the mesh's layout,
every rank gets its own blocks back bitwise. Two ranks with a
``Shard(1)`` float32 and bfloat16 leaf beside a plain one, which could not
be saved before (``.numpy()`` of a DTensor raises), round-trip as well.
"""
import io
import os
import socket
import subprocess
import sys
import zipfile
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.launch import sharding as jsh  # noqa: E402
from repro.training import checkpoint as jckpt  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import Model  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCH = "qwen3-4b"
RTOL, ATOL = 1e-5, 1e-6
TIMEOUT = 120

_STEP = """
import sys
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.launch import sharding as sh
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import Model
from repro_torch.params import tree_leaves, tree_map
from repro_torch.training import adamw_init, checkpoint, make_train_step
from repro_torch.training.data import TokenStream

rank, port, out, arch = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                        world_size=4)
mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
cfg = get_config(arch).reduced()
model = Model(cfg)
init = lambda: model.init(torch.Generator().manual_seed(0))
batch = next(TokenStream(cfg.vocab_size, seed=0).batches(2, 32))
_, pl = sh.input_specs(cfg, InputShape("t", 32, 2, "train"), mesh)
dbatch = sh.distribute({k: torch.from_numpy(v) for k, v in batch.items()}, pl, mesh)
params = sh.param_shardings(init(), mesh)
opt = sh.zero1_adamw_init(params, mesh)
with sh.on_mesh(mesh):
    params, opt, met = make_train_step(model, device="cpu")(params, opt, dbatch)
state = {"params": params, "m": opt.m, "v": opt.v}
checkpoint.save(f"{out}/mesh", state, step=opt.step)
like = tree_map(lambda t: DTensor.from_local(
    torch.full_like(t.to_local(), float("nan")), t.device_mesh, t.placements,
    run_check=False, shape=t.shape, stride=t.stride()), state)
restored, n = checkpoint.restore(f"{out}/mesh", like)
gathered = tree_map(lambda t: t.full_tensor(), state)
res = {"coord": tuple(mesh.get_coordinate()), "step": n,
       "local": [t.to_local().clone() for t in tree_leaves(state)],
       "placements": [repr(tuple(t.placements)) for t in tree_leaves(state)],
       "restored": [t.to_local().clone() for t in tree_leaves(restored)],
       "restored_placements": [repr(tuple(t.placements)) for t in tree_leaves(restored)]}
if rank == 0:
    checkpoint.save(f"{out}/gathered", gathered, step=opt.step)
    p = init()
    p, o, pm = make_train_step(model, device="cpu")(p, adamw_init(p), batch)
    checkpoint.save(f"{out}/plain", {"params": p, "m": o.m, "v": o.v}, step=o.step)
    full = lambda t: t.full_tensor() if isinstance(t, DTensor) else t
    res.update(loss=float(full(met["loss"])), gnorm=float(full(met["grad_norm"])),
               plain_loss=float(pm["loss"]), plain_gnorm=float(pm["grad_norm"]),
               full=list(tree_leaves(gathered)),
               plain=[t.clone() for t in tree_leaves({"params": p, "m": o.m, "v": o.v})])
torch.save(res, f"{out}/rank{rank}.pt")
dist.destroy_process_group()
print("ok")
"""

_SHARD1 = """
import sys
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import Shard, distribute_tensor
from repro_torch.launch.mesh import make_mesh
from repro_torch.params import tree_leaves, tree_map
from repro_torch.training import checkpoint

rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                        world_size=2)
mesh = make_mesh((1, 2), ("data", "model"), device_type="cpu")
arrays = np.load(f"{out}/arrays.npz")
tree = {"w": distribute_tensor(torch.from_numpy(arrays["w"]), mesh, [Shard(1), Shard(1)]),
        "b": distribute_tensor(torch.from_numpy(arrays["b"]).to(torch.bfloat16), mesh,
                               [Shard(1), Shard(1)]),
        "c": torch.from_numpy(arrays["c"])}
checkpoint.save(f"{out}/mesh", tree, step=5)
got, step = checkpoint.restore(f"{out}/mesh", tree_map(torch.zeros_like, tree))
assert step == 5
for a, b in zip(tree_leaves(got), tree_leaves(tree)):
    assert type(a) is type(b) and a.dtype == b.dtype, (type(a), a.dtype)
    if hasattr(b, "placements"):
        assert a.placements == b.placements
        a, b = a.to_local(), b.to_local()
    assert torch.equal(a, b)
dist.destroy_process_group()
print("ok")
"""


def _spawn(script, n, *args):
    """Runs ``script`` as ``n`` ranks of a gloo group on a free port."""
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", script, str(r), str(port), *map(str, args)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(n)]
    try:
        outs = [p.communicate(timeout=TIMEOUT) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0 and out.strip().endswith("ok"), err[-3000:]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("zero1")
    _spawn(_STEP, 4, out, ARCH)
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(4)]
    return out, ranks


def _names(tree, names=()):
    """The leaf names of a tree in ``tree_leaves`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _names(tree[k], names + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _names(v, names)]
    return [(names, tree)]


def _state_leaves():
    """(kind, names, meta leaf) of the saved state {"m", "params", "v"}."""
    specs = _names(Model(get_config(ARCH).reduced()).param_specs())
    return [(kind, names, t) for kind in ("m", "params", "v") for names, t in specs]


def _close(got, want, what):
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL, atol=ATOL, err_msg=what)


def test_zero1_step_on_four_ranks_equals_the_unsharded_step(run):
    """Loss, gradient norm and every updated parameter of the (data 2,
    model 2) step against the plain step."""
    _, ranks = run
    r0 = ranks[0]
    assert r0["loss"] == pytest.approx(r0["plain_loss"], rel=RTOL)
    assert r0["gnorm"] == pytest.approx(r0["plain_gnorm"], rel=RTOL)
    leaves = _state_leaves()
    assert len(r0["full"]) == len(r0["plain"]) == len(leaves)
    for (kind, names, _), got, want in zip(leaves, r0["full"], r0["plain"]):
        if kind == "params":
            _close(got, want, "/".join(names))


def test_zero1_moments_on_four_ranks_equal_the_unsharded_ones(run):
    """The moments' ``full_tensor()`` against the plain step's m and v."""
    _, ranks = run
    r0 = ranks[0]
    for (kind, names, _), got, want in zip(_state_leaves(), r0["full"], r0["plain"]):
        if kind != "params":
            _close(got, want, f"{kind} {'/'.join(names)}")


def _jax_block(t, spec, coords, sizes):
    """The block of ``t`` that a rank at ``coords`` holds under the
    reference's ``spec``: each dim split over its axes, the first major."""
    for dim, axes in enumerate(spec):
        if not axes:
            continue
        n = int(np.prod([sizes[a] for a in axes]))
        block = 0
        for a in axes:
            block = block * sizes[a] + coords[a]
        rows = t.shape[dim] // n
        t = t.narrow(dim, block * rows, rows)
    return t


def test_each_rank_holds_jax_s_block_of_the_moments(run):
    """Each rank's local moment is exactly JAX's block of the global moment
    (the reference's ZeRO-1 spec on a (data 2, model 2) mesh), and that
    block of the plain step's moment within the tolerance; at least one
    leaf's moments split its `model` dim over the data ranks too."""
    _, ranks = run
    sizes = {"data": 2, "model": 2}
    stand_in = type("Mesh", (), {"shape": sizes})()
    split = 0
    for i, (kind, names, t) in enumerate(_state_leaves()):
        leaf = type("Leaf", (), {"shape": tuple(t.shape), "ndim": t.ndim})()
        spec = jsh._leaf_spec(list(names), leaf, stand_in,
                              extra_axes=("data", "pod") if kind != "params" else ())
        spec = tuple(e if e is None or isinstance(e, tuple) else (e,) for e in spec)
        split += kind == "m" and any(e == ("model", "data") for e in spec)
        for r in ranks:
            coords = dict(zip(("data", "model"), r["coord"]))
            want = _jax_block(ranks[0]["full"][i], spec, coords, sizes)
            assert torch.equal(r["local"][i], want), (kind, names, coords)
            if kind != "params":
                _close(r["local"][i], _jax_block(ranks[0]["plain"][i], spec, coords, sizes),
                       f"{kind} {'/'.join(names)} at {coords}")
    assert split >= 4, split


def _members(path):
    with zipfile.ZipFile(path) as zf:
        return {name: zf.read(name) for name in zf.namelist()}


def test_mesh_checkpoint_is_the_global_arrays_file(run, tmp_path):
    """The mesh's file, member for member: byte for byte the port's save of
    the gathered arrays and the JAX package's save of them, and within the
    tolerance the plain step's save (same members, shapes and dtypes)."""
    out, ranks = run
    mesh, gathered = _members(out / "mesh.npz"), _members(out / "gathered.npz")
    assert list(mesh) == list(gathered)
    for name in gathered:
        assert mesh[name] == gathered[name], name
    full = [t.numpy() for t in ranks[0]["full"]]
    jckpt.save(str(tmp_path / "jax"), full, step=1)
    theirs = _members(tmp_path / "jax.npz")
    assert list(theirs) == list(mesh)
    for name in theirs:
        assert mesh[name] == theirs[name], name
    plain = _members(out / "plain.npz")
    assert list(plain) == list(mesh) and plain["__treedef__.npy"] == mesh["__treedef__.npy"]
    for name in plain:
        a, b = (np.load(io.BytesIO(x[name])) for x in (mesh, plain))
        assert a.shape == b.shape and a.dtype == b.dtype, name
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=name)


def test_restore_gives_every_rank_its_own_blocks(run):
    """``restore`` into the mesh's layout: the placements of ``like`` and,
    on every rank, its own local blocks bitwise, the step with them."""
    _, ranks = run
    for r in ranks:
        assert r["step"] == 1
        assert r["restored_placements"] == r["placements"]
        for i, (a, b) in enumerate(zip(r["restored"], r["local"])):
            assert torch.equal(a, b), (r["coord"], i)
    assert any("_StridedShard" in p for p in ranks[0]["placements"])


def test_two_rank_shard1_state_saves_and_restores(tmp_path):
    """Two ranks, a ``Shard(1)`` float32 and bfloat16 leaf and a plain one:
    saved (the parent's ``save`` raised on the DTensor), the file equal
    member for member to the JAX package's save of the same arrays, and
    restored on each rank bitwise into the same layout."""
    import jax.numpy as jnp
    rng = np.random.default_rng(3)
    arrays = {"w": rng.standard_normal((4, 6)).astype(np.float32),
              "b": rng.standard_normal((3, 8)).astype(np.float32),
              "c": rng.standard_normal((5,)).astype(np.float32)}
    np.savez(tmp_path / "arrays.npz", **arrays)
    _spawn(_SHARD1, 2, tmp_path)
    jtree = {"w": jnp.asarray(arrays["w"]), "b": jnp.asarray(arrays["b"], jnp.bfloat16),
             "c": jnp.asarray(arrays["c"])}
    jckpt.save(str(tmp_path / "jax"), jtree, step=5)
    mine, theirs = _members(tmp_path / "mesh.npz"), _members(tmp_path / "jax.npz")
    assert list(mine) == list(theirs)
    for name in theirs:
        assert mine[name] == theirs[name], name
