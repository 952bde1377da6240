"""The port's meshes and placement rules (``repro_torch.launch.mesh``,
``repro_torch.launch.sharding``) against the JAX package's.

* The specs of every leaf of ``param_specs``, ``lora_specs`` and
  ``opt_specs`` of all 11 archs at full width, and of ``batch_specs``,
  ``token_specs`` and ``cache_specs`` at the four input shapes, equal
  JAX's ``spec_for_leaf`` (through ``params_shardings``,
  ``batch_shardings``, ``cache_shardings``) on ``AbstractMesh``es of the
  same shapes, entry for entry, and ``shard_shape`` equals
  ``NamedSharding.shard_shape``, on 1x1, 4x4, 16x16 and 2x16x16 meshes.
  The port's meshes are ``DeviceMesh``es in one subprocess: the host
  mesh over a world-1 ``gloo`` group, the others over fake process
  groups of 16, 256 and 512 ranks (``FakeStore``).
* The dry-run's ``per_device_argument_bytes`` on the 2x16x16 mesh equals
  the bytes of JAX's shard shapes, tree by tree.
* Mesh names resolve and are rejected as in JAX; the production meshes
  need a world of their size.
"""
import json
import math
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding

from repro.configs import ALL_ARCH_IDS as JAX_ARCHS
from repro.configs import INPUT_SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.launch import sharding as JS
from repro.launch import specs as JSP
from repro_torch.configs import ALL_ARCH_IDS, get_config, get_shape
from repro_torch.experiments import ExperimentSpec
from repro_torch.interop import tree_leaves
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as M
from repro_torch.launch import sharding as S

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"1x1": ((1, 1), ("data", "model")),
          "4x4": ((4, 4), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}

#: the port's side: every tree's (shape, spec, shard shape) per leaf on
#: each mesh, built as DeviceMeshes over real or fake process groups
_PORT = r"""
import json, sys
import torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.configs import ALL_ARCH_IDS, INPUT_SHAPES, get_config
from repro_torch.interop import tree_leaves
from repro_torch.launch import mesh as M, sharding as S, specs as SP

trees = {}
for arch in ALL_ARCH_IDS:
    cfg = get_config(arch)
    lora = SP.lora_specs(cfg)
    trees[arch] = {"params": (S.params_shardings, SP.param_specs(cfg)),
                   "lora": (S.params_shardings, lora),
                   "opt": (S.params_shardings, SP.opt_specs(lora))}
    for name, shape in INPUT_SHAPES.items():
        trees[arch][name + "/batch"] = (
            S.batch_shardings, SP.batch_specs(cfg, shape, with_labels=True))
        trees[arch][name + "/tokens"] = (S.batch_shardings,
                                         SP.token_specs(shape))
        if shape.kind == "decode":
            trees[arch][name + "/cache"] = (S.cache_shardings,
                                            SP.cache_specs(cfg, shape))
out = {}
for tag, world in (("1x1", 1), ("4x4", 16), ("16x16", 256),
                   ("2x16x16", 512)):
    if world == 1:
        mesh = M.make_host_mesh("cpu")
        out["host"] = {"shape": list(mesh.shape),
                       "names": list(mesh.mesh_dim_names),
                       "batch_axes": list(M.batch_axes(mesh)),
                       "tp_axis": M.tp_axis(mesh),
                       "backend": dist.get_backend(),
                       "resolved": list(M.resolve_mesh("host", "cpu").shape)}
        try:
            M.make_production_mesh(device="cpu")
        except RuntimeError as e:
            out["host"]["production"] = str(e)
    else:
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)
        mesh = (init_device_mesh("cpu", (4, 4), mesh_dim_names=("data",
                                                                "model"))
                if tag == "4x4" else
                M.make_production_mesh(multi_pod=tag == "2x16x16",
                                       device="cpu"))
    out[tag] = {arch: {name: [(list(t.shape), sh.spec,
                               S.shard_shape(mesh, sh.spec, t.shape))
                              for t, sh in zip(tree_leaves(tree),
                                               tree_leaves(rules(mesh, tree)))]
                       for name, (rules, tree) in by_name.items()}
                for arch, by_name in trees.items()}
    out[tag + "/mesh"] = [list(mesh.shape), list(mesh.mesh_dim_names)]
    dist.destroy_process_group()
print(json.dumps(out))
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return env


@pytest.fixture(scope="module")
def port_specs():
    out = subprocess.run([sys.executable, "-c", _PORT], capture_output=True,
                         text=True, env=_env(), cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _jax_trees(arch):
    cfg = jax_get_config(arch)
    lora = JSP.lora_specs(cfg)
    trees = {"params": (JS.params_shardings, JSP.param_specs(cfg)),
             "lora": (JS.params_shardings, lora),
             "opt": (JS.params_shardings, JSP.opt_specs(lora))}
    for name, shape in JAX_SHAPES.items():
        trees[name + "/batch"] = (JS.batch_shardings,
                                  JSP.batch_specs(cfg, shape,
                                                  with_labels=True))
        trees[name + "/tokens"] = (JS.batch_shardings,
                                   JSP.token_specs(shape))
        if shape.kind == "decode":
            trees[name + "/cache"] = (JS.cache_shardings,
                                      JSP.cache_specs(cfg, shape))
    return trees


def _jax_rows(mesh, rules, tree):
    shardings = jax.tree.leaves(rules(mesh, tree), is_leaf=lambda x:
                                isinstance(x, NamedSharding))
    return [(list(t.shape), tuple(sh.spec), tuple(sh.shard_shape(t.shape)))
            for t, sh in zip(jax.tree.leaves(tree), shardings)]


def _entry(e):
    return tuple(e) if isinstance(e, list) else e


@pytest.fixture(scope="module")
def jax_trees():
    assert list(ALL_ARCH_IDS) == list(JAX_ARCHS)
    return {arch: _jax_trees(arch) for arch in JAX_ARCHS}


@pytest.mark.parametrize("tag", list(MESHES))
def test_placements_equal_jax(port_specs, jax_trees, tag):
    shape, names = MESHES[tag]
    assert port_specs[tag + "/mesh"] == [list(shape), list(names)]
    mesh = AbstractMesh(shape, names)
    n_sharded = 0
    for arch, trees in jax_trees.items():
        got_trees = port_specs[tag][arch]
        assert sorted(got_trees) == sorted(trees), arch
        for name, (rules, tree) in trees.items():
            want = _jax_rows(mesh, rules, tree)
            got = [(s, tuple(_entry(e) for e in spec), tuple(sh))
                   for s, spec, sh in got_trees[name]]
            assert got == want, (tag, arch, name)
            n_sharded += sum(any(e is not None for e in spec)
                             for _, spec, _ in got)
    assert n_sharded > 0


def test_meshes_resolve_as_jax(port_specs):
    host = port_specs["host"]
    assert host["shape"] == host["resolved"] == [1, 1]
    assert host["names"] == ["data", "model"]
    assert host["batch_axes"] == ["data"] and host["tp_axis"] == "model"
    assert host["backend"] == "gloo"
    assert "256 ranks" in host["production"]
    assert M.resolve_mesh(None) is None and M.resolve_mesh("none") is None
    for bad in ("16x16", "tpu"):
        with pytest.raises(ValueError, match="unknown mesh"):
            M.resolve_mesh(bad)
        with pytest.raises(ValueError, match="unknown mesh"):
            ExperimentSpec(mesh=bad)
    with pytest.raises(RuntimeError, match="none is started"):
        M.make_production_mesh(device="cpu")
    assert M.MESH_NAMES == ("none", "host", "production")
    pod = M.abstract_production_mesh(multi_pod=True)
    assert (pod.shape, pod.mesh_dim_names) == MESHES["2x16x16"]
    assert M.batch_axes(pod) == ("pod", "data")


@pytest.mark.parametrize("arch,shape,k_local", [
    ("deepseek-v3-671b", "train_4k", 0),
    ("jamba-v0.1-52b", "decode_32k", 0),
    ("qwen2-vl-7b", "prefill_32k", 0),
    ("granite-moe-1b-a400m", "train_4k", 2),
])
def test_per_device_argument_bytes_equal_jax_shards(arch, shape, k_local):
    """The dry-run's ``--multi-pod`` bytes: each input tree's shards on
    the 2x16x16 mesh, against JAX's shard shapes of the same trees."""
    cfg, sh = get_config(arch), get_shape(shape)
    _fn, args = D.build_cfg(cfg, sh, k_local=k_local)
    got = D.per_device_argument_bytes(
        M.abstract_production_mesh(multi_pod=True), sh.kind, args, k_local)
    mesh = AbstractMesh(*MESHES["2x16x16"])
    jcfg, jsh = jax_get_config(arch), JAX_SHAPES[shape]
    p, lo = JSP.param_specs(jcfg), JSP.lora_specs(jcfg)
    trees = {"params": (JS.params_shardings, p),
             "lora": (JS.params_shardings, lo)}
    batch = JSP.batch_specs(jcfg, jsh, with_labels=sh.kind == "train")
    if k_local:
        batch = jax.tree.map(lambda t: jax.ShapeDtypeStruct(
            (2, k_local) + t.shape, t.dtype), batch)
    if sh.kind == "train" and not k_local:
        trees["opt_state"] = (JS.params_shardings, JSP.opt_specs(lo))
    if sh.kind == "decode":
        trees["batch"] = (JS.batch_shardings, JSP.token_specs(jsh))
        trees["cache"] = (JS.cache_shardings, JSP.cache_specs(jcfg, jsh))
    else:
        trees["batch"] = (JS.batch_shardings, batch)
    want = {name: sum(math.prod(shard) * np.dtype(t.dtype).itemsize
                      for (_, _, shard), t in zip(
                          _jax_rows(mesh, rules, tree),
                          jax.tree.leaves(tree)))
            for name, (rules, tree) in trees.items()}
    assert got == want
    whole = sum(t.numel() * t.element_size() for t in tree_leaves(args[0]))
    assert got["params"] < whole


def test_shard_shape_and_placements():
    mesh = M.abstract_production_mesh(multi_pod=True)
    assert S.shard_shape(mesh, (("pod", "data"), None, "model"),
                         (64, 3, 32)) == (2, 3, 2)
    assert S.shard_shape(mesh, (), ()) == ()
    with pytest.raises(ValueError, match="does not split"):
        S.shard_shape(mesh, ("model",), (24,))
    from torch.distributed.tensor import Replicate, Shard
    assert S.placements(mesh, (("pod", "data"), None, "model")) == [
        Shard(0), Shard(0), Shard(2)]
    assert S.placements(mesh, (None, "data")) == [Replicate(), Shard(1),
                                                  Replicate()]
