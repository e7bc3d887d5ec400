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
    over two mesh axes orders its shards by mesh dim (data-major), where
    JAX orders them by the spec (model-major): the difference the module
    note of ``repro_torch.launch.sharding`` states.
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


def test_two_axis_shards_order_by_mesh_dim(fake_mesh):
    """ZeRO-1 splits qwen3-4b's w1 (2560, 9728) dim 1 over ("model",
    "data"[, "pod"]): the same columns a rank in both packages. JAX orders
    the blocks by the spec (model-major); DTensor by mesh dim (pod, data,
    model). This process is rank 18: data 1, model 2 (pod 0)."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
    sizes = _sizes(fake_mesh)
    spec = sh._leaf_spec(["w1"], _leaf((2560, 9728)), fake_mesh, extra_axes=sh.ZERO_AXES)
    axes = spec[1]
    assert axes == tuple(a for a in ("model", "data", "pod") if a in sizes)
    cols = 9728 // int(np.prod([sizes[a] for a in axes]))
    local, offset = compute_local_shape_and_global_offset(
        (2560, 9728), fake_mesh, sh.to_placements(spec, fake_mesh))
    coords = dict(zip(fake_mesh.mesh_dim_names, fake_mesh.get_coordinate()))
    assert coords["data"] == 1 and coords["model"] == 2
    assert tuple(local) == (2560, cols)
    mesh_order = [a for a in fake_mesh.mesh_dim_names if a in axes]
    assert offset[1] == _block(coords, mesh_order, sizes) * cols      # DTensor
    assert offset[1] != _block(coords, axes, sizes) * cols            # JAX's block
