"""The port's sharding rules (``repro_torch.launch.sharding``) against the
JAX package's (``repro.launch.sharding``), on the CPU.

The rules are pure functions of shapes, so both packages take the same
stand-in mesh (``SimpleNamespace(shape=...)``, as tests/test_sharding.py
does):
  - every case of tests/test_sharding.py through the port's ``_axes_fit``
    and ``_leaf_spec`` (and the reference's, for the same answer);
  - every parameter of all ten architectures at full width, from the port's
    ``Model.param_specs()`` (meta tensors) and JAX's, on both production
    meshes, with and without ZeRO-1's extra axes: the same leaves (names,
    shapes, dtypes) and the same spec;
  - the decode caches' specs at decode_32k and long_500k;
  - on a real ``DeviceMesh`` over a ``fake`` process group of 256 and 512
    ranks, each DTensor's local shard shape is the reference's arithmetic
    (each dim divided by the product of its mesh axes), and a dim split
    over several mesh axes puts each rank on JAX's block, the spec's axes
    major first (ZeRO-1's model-major moments, strided shards in DTensor);
  - on that group, ``adamw_update`` of a leaf whose moments ZeRO-1 splits
    along its `model` dim issues one reduce-scatter and gathers nothing
    larger than the leaf's `model` shard, and creates no storage larger
    than that shard in float32 (``RankCounter``).
"""
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_shape as jget_shape  # noqa: E402
from repro.launch import sharding as jsh  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro_torch.configs import get_config, get_shape  # noqa: E402
from repro_torch.launch import sharding as sh  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.models import Model  # noqa: E402

POD = {"pod": 2, "data": 16, "model": 16}
SINGLE = {"data": 16, "model": 16}
MESHES = {"pod16x16": SimpleNamespace(shape=SINGLE),
          "pod2x16x16": SimpleNamespace(shape=POD)}
MESH = MESHES["pod2x16x16"]


def _leaf(shape):
    return SimpleNamespace(shape=shape, ndim=len(shape))


# ------------------------------------------------ tests/test_sharding.py
# (rule, args, want): every assertion of tests/test_sharding.py; a dict
# checks only the dims it names
CASES = [
    ("axes_fit", (64, ("model",)), ("model",)),
    ("axes_fit", (40, ("model",)), None),               # llama4 heads
    ("axes_fit", (24, ("model",)), None),               # musicgen heads
    ("axes_fit", (1, ("model",)), None),                # MQA kv
    ("axes_fit", (256, ("pod", "data")), ("pod", "data")),
    ("axes_fit", (32, ("pod", "data")), ("pod", "data")),
    ("axes_fit", (16, ("pod", "data")), ("pod",)),      # 16 % 32 != 0
    ("axes_fit", (1, ("pod", "data")), None),
    ("leaf_spec", (["layers", "attn", "wq"], (36, 2560, 32, 128), ()), {2: ("model",)}),
    ("leaf_spec", (["wq"], (5120, 40, 128), ()), (None, None, None)),
    ("leaf_spec", (["wk"], (6144, 1, 128), ()), {1: None}),
    ("leaf_spec", (["we1"], (128, 2048, 768), ()), {0: ("model",)}),
    ("leaf_spec", (["w2"], (48, 13440, 4096), ()), (None, ("model",), None)),
    ("leaf_spec", (["w1"], (2560, 9728), ("data",)), {1: ("model", "data")}),
    ("leaf_spec", (["w1"], (4096, 13440), ("data",)), {1: ("model",)}),
    ("leaf_spec", (["A_log"], (64,), ()), (None,)),
]


def _norm(spec):
    """A spec with each entry None or a tuple of axes: ``PartitionSpec``
    gives a one-axis entry back as the axis name itself."""
    return tuple(e if e is None or isinstance(e, tuple) else (e,) for e in spec)


def _check_case(rule, args, want, mod):
    if rule == "axes_fit":
        got = mod._axes_fit(*args, MESH)
        assert got == want
        return
    names, shape, extra = args
    got = _norm(mod._leaf_spec(names, _leaf(shape), MESH, extra_axes=extra))
    if isinstance(want, dict):
        assert {d: got[d] for d in want} == want
    else:
        assert got == want


@pytest.mark.parametrize("rule,args,want", CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_rule_cases_of_the_reference(rule, args, want):
    """The port answers each case of tests/test_sharding.py as asserted
    there, and as the reference answers it."""
    _check_case(rule, args, want, sh)
    _check_case(rule, args, want, jsh)


# ------------------------------------------------ every leaf at full width
def _port_leaves(tree, names=()):
    """(names, leaf) in ``tree_leaves`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _port_leaves(tree[k], names + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _port_leaves(v, names)]
    return [(names, tree)]


def _is_spec(x):
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, tuple) and all(isinstance(a, str) for a in e) for e in x)


def _spec_leaves(tree):
    """The per-dim specs of a tree of them, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _spec_leaves(tree[k])]
    if isinstance(tree, list) or isinstance(tree, tuple) and not _is_spec(tree):
        return [x for v in tree for x in _spec_leaves(v)]
    return [tree]


def _jax_leaves(tree):
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        names = tuple(k.key for k in path if isinstance(getattr(k, "key", None), str))
        out.append((names, leaf))
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_and_leaf_specs_match_at_full_width(arch):
    """``Model.param_specs()``: meta tensors of JAX's shapes, dtypes and
    leaf names, allocating nothing; every leaf's spec equal to JAX's on
    both production meshes, with and without ZeRO-1's ("data", "pod")."""
    specs = Model(get_config(arch)).param_specs()
    port = _port_leaves(specs)
    ref = _jax_leaves(JModel(jget_config(arch)).param_specs())
    assert len(port) == len(ref)
    for (names, t), (jnames, j) in zip(port, ref):
        assert names == jnames
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(j.shape)
        assert str(t.dtype).split(".")[-1] == str(j.dtype)
    for mesh in MESHES.values():
        for extra in ((), ("data", "pod")):
            for (names, t), (_, j) in zip(port, ref):
                got = sh._leaf_spec(list(names), t, mesh, extra_axes=extra)
                want = _norm(jsh._leaf_spec(list(names), j, mesh, extra_axes=extra))
                assert got == want, (arch, names, extra)


@pytest.mark.parametrize("shape_name", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_match(arch, shape_name, monkeypatch):
    """The decode cache's specs (``cache_shardings`` over
    ``make_cache(as_specs=True)``) equal the reference's on both meshes.
    The reference wraps each spec in a ``NamedSharding``, which needs a
    real mesh: here it hands the spec back instead."""
    monkeypatch.setattr(jsh, "NamedSharding", lambda mesh, spec: spec)
    shape = get_shape(shape_name)
    jshape = jget_shape(shape_name)
    model, jmodel = Model(get_config(arch)), JModel(jget_config(arch))
    cache = model.make_cache(shape.global_batch, shape.seq_len, as_specs=True)
    jcache = jmodel.make_cache(jshape.global_batch, jshape.seq_len, as_specs=True)
    for mesh in MESHES.values():
        got = _spec_leaves(sh.cache_shardings(model, cache, mesh))
        want = jax.tree_util.tree_leaves(
            jsh.cache_shardings(jmodel, jcache, mesh),
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        assert len(got) == len(want) > 0
        assert got == [_norm(w) for w in want], arch


# ------------------------------------------------ on a fake process group
@pytest.fixture(scope="module", params=[False, True], ids=["pod16x16", "pod2x16x16"])
def fake_mesh(request):
    """The production ``DeviceMesh`` over a ``fake`` process group in this
    process, as rank 18 (data 1, model 2 on the single-pod mesh), torn
    down after the module: the workers run other files after this one."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    world = 512 if request.param else 256
    dist.init_process_group("fake", store=FakeStore(), rank=18, world_size=world)
    try:
        yield make_production_mesh(multi_pod=request.param, device_type="cpu")
    finally:
        dist.destroy_process_group()


def _sizes(mesh):
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


@pytest.mark.parametrize("arch", ["qwen3-4b", "qwen3-moe-30b-a3b", "mamba2-1.3b",
                                  "recurrentgemma-9b", "codeqwen1.5-7b", "qwen2-vl-72b"])
def test_local_shard_shapes_are_the_reference_arithmetic(fake_mesh, arch):
    """``param_shardings`` of the meta specs on the real mesh: each local
    shard's shape is each dim divided by the product of the axes JAX's
    spec names, with and without ZeRO-1's axes; and ``zero1_adamw_init``'s
    moments have the ZeRO-1 shapes in float32."""
    sizes = _sizes(fake_mesh)
    stand_in = SimpleNamespace(shape=sizes)
    specs = Model(get_config(arch)).param_specs()
    ref = _jax_leaves(JModel(jget_config(arch)).param_specs())
    for extra in ((), sh.ZERO_AXES):
        dist_specs = sh.param_shardings(specs, fake_mesh, extra_axes=extra)
        for (names, t), (_, j) in zip(_port_leaves(dist_specs), ref):
            spec = _norm(jsh._leaf_spec(list(names), j, stand_in, extra_axes=extra))
            want = tuple(d // int(np.prod([sizes[a] for a in (s or ())]))
                         for d, s in zip(j.shape, spec))
            assert tuple(t.to_local().shape) == want, (names, extra)
    opt = sh.zero1_adamw_init(sh.param_shardings(specs, fake_mesh), fake_mesh)
    for (names, m), (_, j) in zip(_port_leaves(opt.m), ref):
        spec = _norm(jsh._leaf_spec(list(names), j, stand_in, extra_axes=sh.ZERO_AXES))
        want = tuple(d // int(np.prod([sizes[a] for a in (s or ())]))
                     for d, s in zip(j.shape, spec))
        assert tuple(m.to_local().shape) == want and m.dtype == torch.float32


def _block(coords, axes, sizes):
    """The block a rank holds of a dim split over ``axes``, major first."""
    block = 0
    for a in axes:
        block = block * sizes[a] + coords[a]
    return block


# ranks probed on both meshes: rank 18 (data 1, model 2 on pod16x16), the
# first and the last, and one in each pod of pod2x16x16
PROBED = (0, 18, 37, 255, 300, 511)


def _coords(mesh, rank):
    """A rank's coordinate on ``mesh`` (ranks laid out row-major)."""
    out, rest = [], rank
    for size in reversed(mesh.shape):
        out.append(rest % size)
        rest //= size
    return tuple(reversed(out))


def _offset(shape, mesh, placements, coord):
    """(local shape, global offset) DTensor gives the rank at ``coord``."""
    from torch.distributed.tensor._utils import _compute_local_shape_and_global_offset
    return _compute_local_shape_and_global_offset(shape, mesh.shape, list(coord), placements)


def _check_blocks(mesh, shape, dim, spec, strided):
    """Each probed rank of ``mesh`` holds, of ``shape``'s dim ``dim`` split
    by ``spec``, JAX's block (the spec's axes major first), by DTensor's
    own offsets and by ``mesh.shard_blocks`` (the optimizer's and the
    checkpoint's arithmetic); the axes in ``strided`` are the strided
    shards; and this process's own shard, cut by DTensor from real
    values, is that block."""
    from repro_torch.launch.mesh import shard_blocks
    sizes = _sizes(mesh)
    axes = spec[dim]
    placements = sh.to_placements(spec, mesh)
    assert [type(p).__name__ == "_StridedShard" for p in placements] == \
        [a in strided for a in sizes]
    n = int(np.prod([sizes[a] for a in axes]))
    rows = shape[dim] // n
    for rank in PROBED:
        if rank >= mesh.size():
            continue
        coord = _coords(mesh, rank)
        coords = dict(zip(mesh.mesh_dim_names, coord))
        local, offset = _offset(shape, mesh, placements, coord)
        block = _block(coords, axes, sizes)
        assert local[dim] == rows and offset[dim] == block * rows, (rank, coords)
        assert shard_blocks(placements, mesh.shape, coord, dim, n) == [block]
    coords = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    x = torch.arange(shape[dim]).reshape([-1 if d == dim else 1 for d in range(2)]).expand(shape)
    got = torch.distributed.tensor.distribute_tensor(x, mesh, placements,
                                                     src_data_rank=None).to_local()
    first = _block(coords, axes, sizes) * rows
    assert torch.equal(got.select(1 - dim, 0), torch.arange(first, first + rows))


def test_two_axis_shards_order_by_mesh_dim(fake_mesh):
    """ZeRO-1 splits qwen3-4b's w1 (2560, 9728) dim 1 over ("model",
    "data"[, "pod"]). DTensor splits by mesh dim, (pod,) data, model; the
    port's placements make the data and pod axes strided shards, so that
    every rank holds JAX's block, model-major: a slice of its own `model`
    shard (plain ``Shard``s would put it on the data-major block). Probed
    at six ranks of both meshes."""
    sizes = _sizes(fake_mesh)
    shape = (2560, 9728)
    spec = sh._leaf_spec(["w1"], _leaf(shape), fake_mesh, extra_axes=sh.ZERO_AXES)
    assert spec[1] == tuple(a for a in ("model", "data", "pod") if a in sizes)
    _check_blocks(fake_mesh, shape, 1, spec, ("data", "pod"))
    cols, model_cols = 9728 // int(np.prod(list(sizes.values()))), 9728 // sizes["model"]
    for rank in PROBED:
        if rank < fake_mesh.size():
            coords = dict(zip(fake_mesh.mesh_dim_names, _coords(fake_mesh, rank)))
            start = _block(coords, spec[1], sizes) * cols
            assert coords["model"] * model_cols <= start < (coords["model"] + 1) * model_cols


def test_batch_shards_sit_on_jax_blocks(fake_mesh):
    """``batch``'s ("pod", "data") on the train_4k batch (256, 4096) dim 0
    follows the mesh's order: plain ``Shard``s, each rank on JAX's block."""
    sizes = _sizes(fake_mesh)
    spec = (sh.batch_spec(256, fake_mesh), None)
    assert spec[0] == tuple(a for a in ("pod", "data") if a in sizes)
    _check_blocks(fake_mesh, (256, 4096), 0, spec, ())


def test_one_rank_mesh_needs_no_stride():
    """On a (1, 1) mesh every split factor is one: plain ``Shard``s, the
    layout the card's one-rank mesh trains on."""
    mesh = SimpleNamespace(shape={"data": 1, "model": 1})
    spec = sh._leaf_spec(["w1"], _leaf((256, 512)), mesh, extra_axes=sh.ZERO_AXES)
    assert spec == (None, ("model", "data"))
    assert sh.to_placements(spec, mesh) == (sh.Shard(1), sh.Shard(1))


def _zero1_leaf(mesh):
    """Reduced qwen3-4b's stacked w1 (layers, d, d_ff) on ``mesh`` with its
    ZeRO-1 moments, and a gradient laid out as the backward leaves it: a
    sum pending over the batch ranks, the parameter's `model` shard."""
    from torch.distributed.tensor import DTensor, Partial
    specs = Model(get_config("qwen3-4b").reduced()).param_specs()
    w1 = next(t for names, t in _port_leaves(specs) if names[-1] == "w1")
    params = sh.param_shardings({"w1": torch.zeros(w1.shape, dtype=torch.float32)}, mesh)
    p = params["w1"]
    opt = sh.zero1_adamw_init(params, mesh)
    assert opt.m["w1"].placements != p.placements        # ZeRO-1 splits the model shard
    placements = [pl if pl.is_shard() else Partial() for pl in p.placements]
    g = DTensor.from_local(torch.ones(p.to_local().shape), mesh, placements, run_check=False,
                           shape=p.shape, stride=p.stride())
    return params, {"w1": g}, opt, p.to_local().numel()


def test_zero1_update_stays_in_the_model_shard(fake_mesh):
    """``adamw_update`` on a leaf whose moments ZeRO-1 splits along its
    `model` dim: one reduce-scatter (the gradient into the moments'
    layout) and one all-gather (the update back), over the ZeRO ranks,
    seen by a ``CommDebugMode``; no all-gather result larger than the
    leaf's `model` shard."""
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch.launch.dryrun import RankCounter
    from repro_torch.training.optimizer import adamw_update
    params, grads, opt, shard = _zero1_leaf(fake_mesh)
    with CommDebugMode() as comm:
        adamw_update(params, grads, opt, lr=1e-3)
    counts = {str(k).split(".")[-1]: v for k, v in comm.get_comm_counts().items()}
    assert counts.get("reduce_scatter_tensor", 0) <= 1, counts
    assert counts.get("all_gather_into_tensor", 0) == 1, counts
    counter = RankCounter()
    with counter:
        with counter.span("opt"):
            adamw_update(params, grads, opt, lr=1e-3)
    span = counter.spans["opt"]
    assert span["calls"]["reduce-scatter"] <= 1 and span["calls"]["all-gather"] == 1
    assert 0 < span["largest_result"]["all-gather"] <= shard * 4, (span, shard)


def test_zero1_update_creates_nothing_past_the_shard_in_float32(fake_mesh):
    """``RankCounter`` (``launch/dryrun.py``) over the update: rank 0's
    largest storage created inside ``adamw_update`` is at most the leaf's
    `model` shard in float32 (the parent gathered the whole leaf)."""
    from repro_torch.launch.dryrun import RankCounter
    from repro_torch.training.optimizer import adamw_update
    params, grads, opt, shard = _zero1_leaf(fake_mesh)
    counter = RankCounter()
    with counter:
        counter.watch((params, grads, opt))
        with counter.span("adamw_update"):
            adamw_update(params, grads, opt, lr=1e-3)
    largest = counter.spans["adamw_update"]["largest_storage"]
    assert 0 < largest <= shard * 4, (largest, shard)
