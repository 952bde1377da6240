"""Device meshes (the JAX package's ``repro.launch.mesh``), as
``torch.distributed.device_mesh.DeviceMesh``es with JAX's shapes and
axis names:

* host: (1, 1) over ("data", "model"), the local device;
* production: (16, 16) over ("data", "model");
* multi-pod: (2, 16, 16) over ("pod", "data", "model").

The ``pod`` axis is pure data parallelism and doubles as the federated
*silo* axis (DESIGN.md §3). A ``DeviceMesh`` needs a process group of
its size: ``make_host_mesh`` starts a world-1 group when none exists
(``nccl`` for a ``cuda`` device, ``gloo`` for ``cpu``); the production
meshes need a world of 256 or 512 ranks already started. Nothing here
runs at import.

``AbstractMesh`` is a mesh's shape and axis names with no devices and no
group (``jax.sharding.AbstractMesh``): what the one-card dry-run sizes a
pod's shards by.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

HOST_SHAPE = ((1, 1), ("data", "model"))
POD_SHAPE = ((16, 16), ("data", "model"))
MULTI_POD_SHAPE = ((2, 16, 16), ("pod", "data", "model"))

MESH_NAMES = ("none", "host", "production")


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's ``shape`` and ``mesh_dim_names``, no devices: enough for
    the placement rules and ``sharding.shard_shape``, not for placing."""
    shape: Tuple[int, ...]
    mesh_dim_names: Tuple[str, ...]


def abstract_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    return AbstractMesh(*(MULTI_POD_SHAPE if multi_pod else POD_SHAPE))


def _device_type(device) -> str:
    kind = torch.device(device).type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"a mesh lives on cuda or cpu devices, not {kind}")
    return kind


def _mesh(shape, names, device) -> DeviceMesh:
    world = dist.get_world_size()
    size = 1
    for n in shape:
        size *= n
    if world != size:
        raise RuntimeError(f"a {'x'.join(map(str, shape))} mesh needs a "
                           f"world of {size} ranks; this one has {world}")
    return init_device_mesh(_device_type(device), tuple(shape),
                            mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False,
                         device="cuda") -> DeviceMesh:
    """The (16, 16) pod mesh, or the (2, 16, 16) multi-pod one, over the
    process group already started (256 or 512 ranks); raises otherwise."""
    if not dist.is_initialized():
        raise RuntimeError("the production mesh needs a process group of "
                           "256 (512 multi-pod) ranks; none is started")
    return _mesh(*(MULTI_POD_SHAPE if multi_pod else POD_SHAPE), device)


def make_host_mesh(device="cuda") -> DeviceMesh:
    """1x1 mesh on ``device``'s kind. Starts a world-1 process group on
    a ``HashStore`` when none exists (``nccl`` for cuda, ``gloo`` for
    cpu); a failure to start it raises."""
    kind = _device_type(device)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if kind == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0,
                                world_size=1)
    return _mesh(*HOST_SHAPE, device)


def resolve_mesh(name: Optional[str], device="cuda"):
    """Mesh named by a config/CLI string: ``None``/"none" -> no mesh,
    "host" -> 1x1 on ``device``, "production" -> single-pod 16x16."""
    if name is None or name == "none":
        return None
    if name == "host":
        return make_host_mesh(device)
    if name == "production":
        return make_production_mesh(device=device)
    raise ValueError(f"unknown mesh {name!r}; known: {MESH_NAMES}")


def batch_axes(mesh) -> tuple:
    """Mesh axes the global batch is sharded over."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def tp_axis(mesh) -> str:
    return "model"
