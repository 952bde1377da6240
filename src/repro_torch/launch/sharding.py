"""Parameter / activation placement rules: 2-D "FSDP × TP" (the JAX
package's ``repro.launch.sharding``, the same rules).

Weight matmuls shard (in_dim -> fsdp, out_dim -> tp); reverse for output
projections. Expert tensors put the expert dim on the tensor axis
(expert parallelism). A dim is sharded only when divisible by the axis
size — non-divisible dims (e.g. 28 q-heads) stay replicated on that
axis.

A spec is a tuple with one entry per tensor dim: None (replicated), an
axis name, or a tuple of axis names (the dim split over several axes,
the first major) — the entries of JAX's ``PartitionSpec``. A leaf's
path is its key path as ``interop.tree_paths`` gives it. The rules read
only a mesh's ``mesh_dim_names`` and ``shape``, so they take a
``DeviceMesh`` or a ``mesh.AbstractMesh``; ``place``, ``local_part`` and
``gather_part`` need a ``DeviceMesh``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

FSDP = "data"
TP = "model"

# rules keyed by leaf name: tuple of axis names per dim (stack dim excluded)
_RULES_2D = {
    "embed": (TP, FSDP),
    "lm_head": (FSDP, TP),
    "vis_proj": (FSDP, TP),
    "wq": (FSDP, TP), "wk": (FSDP, TP), "wv": (FSDP, TP),
    "wg": (FSDP, TP), "wu": (FSDP, TP),
    "wq_a": (FSDP, None), "wkv_a": (FSDP, None),
    "wq_b": (FSDP, TP), "wkv_b": (FSDP, TP),
    "in_proj": (FSDP, TP),
    "wo": (TP, FSDP), "wd": (TP, FSDP), "out_proj": (TP, FSDP),
    "router": (FSDP, None),
    "a": (FSDP, None),        # lora down
    "b": (None, TP),          # lora up
    "conv_w": (None, None),
}
_RULES_3D = {                  # (E, in, out) expert tensors
    "wg": (TP, FSDP, None), "wu": (TP, FSDP, None),
    "wd": (TP, None, FSDP),
}


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (``jax.sharding.NamedSharding``)."""
    mesh: Any
    spec: Tuple


def axis_size(mesh, axis: str) -> int:
    return mesh.shape[mesh.mesh_dim_names.index(axis)]


def _spec(*entries) -> Tuple:
    """A spec as ``PartitionSpec`` keeps it: a one-axis tuple entry is
    the axis name."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in entries)


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _map(fn, tree, *rest, path=()):
    """``fn(path, leaf, *rest_leaves)`` over dicts, lists, tuples and
    named tuples (an optimizer state), keeping the structure."""
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k], *(r[k] for r in rest), path=path + (k,))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        items = [_map(fn, *vs, path=path + (i,))
                 for i, vs in enumerate(zip(tree, *rest))]
        return type(tree)(*items) if hasattr(tree, "_fields") \
            else type(tree)(items)
    return fn(path, tree, *rest)


def _axis_fits(mesh, axis: Optional[str], dim: int) -> Optional[str]:
    if axis is None:
        return None
    return axis if dim % axis_size(mesh, axis) == 0 else None


def spec_for_leaf(mesh, path, leaf) -> Tuple:
    """Right-align the name rule to the trailing dims — leading layer-stack
    (and any client) axes stay unsharded automatically, so the same rules
    cover params, LoRA trees and Adam mu/nu mirrors."""
    names = [p if isinstance(p, str) else None for p in path]
    name = names[-1] if names else None
    shape = tuple(leaf.shape)
    nd = len(shape)
    rule = None
    if name in _RULES_3D and nd >= 4 and "ffn" in names:
        rule = _RULES_3D[name]          # stacked expert tensor (L, E, i, o)
    elif name in _RULES_2D and nd >= 2:
        rule = _RULES_2D[name]
    if rule is None or nd < len(rule):
        return (None,) * nd
    return (None,) * (nd - len(rule)) + tuple(
        _axis_fits(mesh, a, d) for a, d in zip(rule, shape[nd - len(rule):]))


def params_shardings(mesh, tree):
    """NamedSharding tree for a params/lora/opt-state tree."""
    return _map(lambda path, leaf: NamedSharding(
        mesh, spec_for_leaf(mesh, path, leaf)), tree)


def _dims_batch_axes(mesh, batch_dim: int):
    """Largest prefix of (pod,data) axes that divides the batch dim."""
    picked, prod = [], 1
    for a in ("pod", "data"):
        if a in mesh.mesh_dim_names \
                and batch_dim % (prod * axis_size(mesh, a)) == 0:
            picked.append(a)
            prod *= axis_size(mesh, a)
    return tuple(picked) if picked else None


def batch_shardings(mesh, tree):
    """Shard dim 0 (batch, or the sampled-client axis of stacked client
    batches) over pod+data; everything else replicated."""
    def leaf(path, t):
        shape = tuple(t.shape)
        if not shape:
            return NamedSharding(mesh, ())
        return NamedSharding(mesh, _spec(_dims_batch_axes(mesh, shape[0]),
                                         *(None,) * (len(shape) - 1)))

    return _map(leaf, tree)


def cache_shardings(mesh, tree):
    """Decode caches: batch dim over pod+data; head-ish dims over TP when
    divisible. Cache leaves inside 'stacks' carry a leading layer dim."""
    def leaf(path, t):
        names = [p if isinstance(p, str) else None for p in path]
        shape = tuple(t.shape)
        if not shape or names[-1] == "pos":
            return NamedSharding(mesh, _spec(_dims_batch_axes(
                mesh, shape[0])) if shape else ())
        stacked = "stacks" in names
        dims = list(shape[1:]) if stacked else list(shape)
        spec = [None] * len(dims)
        if dims:
            spec[0] = _dims_batch_axes(mesh, dims[0])  # batch dim
        # shard kv-head / ssm-head dims on TP when they fit
        name = names[-1]
        if name in ("k", "v") and len(dims) == 4:
            spec[2] = _axis_fits(mesh, TP, dims[2])
        if name == "ssm" and len(dims) == 4:
            spec[1] = _axis_fits(mesh, TP, dims[1])
        if name == "conv" and len(dims) == 3:
            spec[2] = _axis_fits(mesh, TP, dims[2])
        if name in ("cross_k", "cross_v") and len(dims) == 4:
            spec[2] = _axis_fits(mesh, TP, dims[2])
        if stacked:
            spec = [None] + spec
        return NamedSharding(mesh, _spec(*spec))

    return _map(leaf, tree)


def replicated(mesh, tree):
    return _map(lambda path, t: NamedSharding(mesh, ()), tree)


# ---------------------------------------------------------------------------
# Specs on a mesh: shard shapes, DTensor placements, trees placed
# ---------------------------------------------------------------------------


def shard_shape(mesh, spec, shape) -> Tuple[int, ...]:
    """One device's shard of a ``shape`` tensor under ``spec``
    (``NamedSharding.shard_shape``); a dim its axes do not divide
    raises."""
    out = list(shape)
    for i, entry in enumerate(spec):
        n = math.prod(axis_size(mesh, a) for a in _axes(entry))
        if out[i] % n:
            raise ValueError(f"dim {i} of {tuple(shape)} does not split "
                             f"over {entry} ({n} ways)")
        out[i] //= n
    return tuple(out)


def placements(mesh, spec) -> list:
    """DTensor placements of ``spec``: ``Shard(dim)`` on each mesh dim
    that splits a tensor dim, ``Replicate()`` on the others. A tensor
    dim over several axes is split in mesh-dim order, the first major,
    as ``PartitionSpec`` splits it."""
    out = [Replicate()] * len(mesh.mesh_dim_names)
    for dim, entry in enumerate(spec):
        for a in _axes(entry):
            out[mesh.mesh_dim_names.index(a)] = Shard(dim)
    return out


def place(tree, shardings):
    """Each tensor of ``tree`` as a DTensor on its sharding's mesh
    (``distribute_tensor``; every rank passes the same tree)."""
    return _map(lambda path, t, sh: distribute_tensor(
        t, sh.mesh, placements(sh.mesh, sh.spec))
        if isinstance(t, torch.Tensor) else t, tree, shardings)


def _full(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


def gathered(tree):
    """Every DTensor of ``tree`` gathered whole on each rank; plain
    tensors as they are."""
    return _map(lambda path, t: _full(t), tree)


def local_part(mesh, spec, t: torch.Tensor) -> torch.Tensor:
    """This rank's shard of ``t`` under ``spec``, sliced from the whole
    tensor every rank holds (no communication): the shard a DTensor of
    ``spec`` keeps here."""
    coord = mesh.get_coordinate()
    index = []
    for dim, entry in enumerate(spec):
        pos, n = 0, 1
        for a in _axes(entry):
            k = mesh.mesh_dim_names.index(a)
            pos, n = pos * mesh.shape[k] + coord[k], n * mesh.shape[k]
        size = t.shape[dim] // n
        index.append(slice(pos * size, (pos + 1) * size))
    return t[tuple(index)]


def gather_part(mesh, spec, t: torch.Tensor) -> torch.Tensor:
    """Inverse of ``local_part``: the ranks' shards of ``spec`` gathered
    into the whole tensor, in mesh order, on every rank."""
    return DTensor.from_local(t, mesh, placements(mesh, spec),
                              run_check=False).full_tensor()
