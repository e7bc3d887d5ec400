"""Production mesh construction.

The port of ``repro/launch/mesh.py``: the same two shapes and axis names.
Single pod: (data=16, model=16) = 256 ranks; multi-pod: (pod=2, data=16,
model=16) = 512 ranks. A mesh is a ``torch.distributed`` ``DeviceMesh``
over the default process group, which the caller has already set up
(``init_process_group`` with its world size and rank; the dry run uses the
``fake`` backend). Nothing here creates or destroys a process group, and
importing this module touches no device.
"""
from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

SINGLE_POD = ((16, 16), ("data", "model"))
MULTI_POD = ((2, 16, 16), ("pod", "data", "model"))


def make_mesh(shape, axis_names, *, device_type="cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axis_names`` over the process
    group that is up. Raises unless one is up with exactly as many ranks
    as the mesh holds."""
    shape, axis_names = tuple(shape), tuple(axis_names)
    size = 1
    for n in shape:
        size *= n
    if not dist.is_initialized():
        raise RuntimeError(f"a {shape} mesh needs a process group of {size} ranks; "
                           "none is initialized")
    if dist.get_world_size() != size:
        raise RuntimeError(f"a {shape} mesh needs {size} ranks; the process group "
                           f"has {dist.get_world_size()}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axis_names)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    shape, axes = MULTI_POD if multi_pod else SINGLE_POD
    return make_mesh(shape, axes, device_type=device_type)


def mesh_sizes(mesh) -> dict:
    """{axis name: size}: a ``DeviceMesh``'s, or ``mesh.shape`` itself where
    it is already such a dict (the stand-in meshes of the rule tests)."""
    if isinstance(mesh.shape, dict):
        return dict(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def data_axes(mesh) -> tuple:
    return tuple(a for a in mesh_sizes(mesh) if a in ("pod", "data"))


def model_axis_size(mesh) -> int:
    return mesh_sizes(mesh)["model"]
