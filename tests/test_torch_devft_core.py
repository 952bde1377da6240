"""The PyTorch port's DevFT core (``repro_torch.core``) against the JAX
package's ``repro.core``.

* Stage schedules and capacities are integers: exactly equal over a
  grid, the error cases included.
* ``layer_vectors`` picks the JAX package's stride subsample leaf by
  leaf, never building the concatenation: the vector is exactly equal
  (the f32 values are copies), with and without the LoRA leaves, with
  bf16 leaves, and with a ``max_elems`` small enough that the stride
  crosses leaf boundaries at every offset.
* ``similarity_matrix``: f32 at 1e-6 (dot products of up to 2**20
  elements summed in another order).
* Group lists are integers: exactly equal for dglg (the JAX clustering
  code on W from each side), random and even. Where dglg could flip on a
  W that differs by an ulp, the message shows the Laplacian's eigen-gap.
* ``fuse_stack`` (dblf, sum, rone, anchor) and ``transfer_stage``:
  bit-exact in f32 and bf16 — each group's members are added one at a
  time in layer order in the leaf's dtype, as ``jax.ops.segment_sum``
  does on the CPU.
* ``build_submodel`` on reduced granite-moe-1b-a400m and llama2-7b-proxy:
  the same plan, sub-config and fused tensors.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as J
from repro.configs import get_config as jax_get_config
from repro.configs import reduce_config as jax_reduce_config
from repro.models import transformer as JT
from repro_torch import core as P
from repro_torch import interop
from repro_torch.configs import (ReducedSpec, get_config, reduce_config,
                                 shared_fields)

torch.set_num_threads(1)


def _stack(seed, n_layers=8, dtype=np.float32):
    rng = np.random.default_rng(seed)
    tree = {"w": rng.standard_normal((n_layers, 6, 5)),
            "z": {"b": rng.standard_normal((n_layers, 7)),
                  "a": rng.standard_normal((n_layers, 3, 3))}}
    tree = jax.tree.map(lambda a: a.astype(np.float32), tree)
    if dtype != np.float32:
        tree = jax.tree.map(lambda a: np.asarray(jnp.asarray(a).astype(dtype)),
                            tree)
    return tree


def _eq_tree(got, want):
    gl, wl = interop.tree_leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        assert g.dtype == getattr(torch, w.dtype.name)
        assert np.array_equal(g.float().numpy(), w.astype(np.float32))


# ---------------------------------------------------------------------------
# stages
# ---------------------------------------------------------------------------


def _schedule_or_error(mod, *args):
    try:
        return mod.capacity_schedule(*args)
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("n_layers", [1, 2, 3, 4, 5, 8, 24, 32, 40, 61])
def test_capacity_schedules_are_equal(n_layers):
    for n_stages in (1, 2, 3, 4, 6):
        for growth in (0.5, 1.0, 1.5, 2.0, 3.0):
            for initial in (None, 1, 3, 5):
                args = (n_layers, n_stages, growth, initial)
                assert _schedule_or_error(P, *args) \
                    == _schedule_or_error(J, *args), args
        for rounds in (1, 4, 7, 30):
            assert P.make_schedule(n_layers, rounds, 3) \
                .__dict__ == J.make_schedule(n_layers, rounds, 3).__dict__
    # granite-moe-1b-a400m at full depth, four stages: 3 -> 6 -> 12 -> 24
    assert P.capacity_schedule(24, 4) == J.capacity_schedule(24, 4) \
        == [3, 6, 12, 24]


def test_stack_capacities_are_equal():
    for sizes in ({"layers": 8}, {"dense": 1, "moe": 2},
                  {"mamba_mlp": 4, "mamba_moe": 3, "attn_mlp": 1},
                  {"enc": 2, "dec": 4}, {"a": 0, "b": 5}, {"a": 3, "b": 3}):
        for cap in range(0, sum(sizes.values()) + 3):
            assert P.allocate_stack_capacities(sizes, cap) \
                == J.allocate_stack_capacities(sizes, cap), (sizes, cap)


# ---------------------------------------------------------------------------
# DGLG
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("max_elems", [1 << 20, 64, 37, 10, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_vectors_are_equal(max_elems, dtype):
    stack = _stack(1, dtype=np.float32 if dtype == "float32"
                   else jnp.bfloat16)
    lora = _stack(2)
    for lo in (None, lora):
        want = J.layer_vectors(jax.tree.map(jnp.asarray, stack),
                               None if lo is None
                               else jax.tree.map(jnp.asarray, lo),
                               max_elems=max_elems)
        got = P.layer_vectors(interop.from_numpy_tree(stack),
                              None if lo is None
                              else interop.from_numpy_tree(lo),
                              max_elems=max_elems)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_similarity_matrix_matches_jax():
    rng = np.random.default_rng(3)
    base = rng.standard_normal((1, 4000)).astype(np.float32)
    # near-identical layers (the homogeneous-init regime) and unrelated ones
    vecs = np.concatenate([base + 1e-3 * rng.standard_normal((5, 4000)),
                           rng.standard_normal((3, 4000))]).astype(np.float32)
    got = P.similarity_matrix(torch.from_numpy(vecs))
    want = J.similarity_matrix(jnp.asarray(vecs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


def _eigen_gap(w, n_groups):
    w = np.array(w, dtype=np.float64)
    np.fill_diagonal(w, 0.0)
    ev = np.linalg.eigvalsh(np.diag(w.sum(1)) - w)
    return ev[n_groups] - ev[n_groups - 1], ev


@pytest.mark.parametrize("n_groups", [1, 2, 3, 5, 8])
def test_groupings_are_equal(n_groups):
    stack = _stack(4)
    pstack, jstack = interop.from_numpy_tree(stack), \
        jax.tree.map(jnp.asarray, stack)
    for seed in (0, (3, 1)):
        want = J.make_groups("dglg", jstack, None, n_groups, seed=seed)
        got = P.make_groups("dglg", pstack, None, n_groups, seed=seed)
        w = J.similarity_matrix(J.layer_vectors(jstack))
        assert got == want, ("eigen-gap", _eigen_gap(w, min(n_groups, 7)))
        for method in ("random", "even"):
            assert P.make_groups(method, pstack, None, n_groups, seed=seed) \
                == J.make_groups(method, jstack, None, n_groups, seed=seed)
    with pytest.raises(ValueError, match="unknown grouping"):
        P.make_groups("kmeans", pstack, None, 2)


# ---------------------------------------------------------------------------
# DBLF and transfer
# ---------------------------------------------------------------------------

GROUPS = [[0, 2, 5], [1, 3], [4, 6, 7]]


@pytest.mark.parametrize("variant", ["dblf", "sum", "rone", "anchor"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fuse_stack_is_bit_exact(variant, dtype):
    stack = _stack(5, dtype=np.float32 if dtype == "float32"
                   else jnp.bfloat16)
    for groups in (GROUPS, [[0], [1, 2, 3, 4, 5, 6, 7]],
                   [[i] for i in range(8)]):
        want = J.fuse_stack(jax.tree.map(jnp.asarray, stack), groups, 0.1,
                            variant, seed=(2, 1))
        got = P.fuse_stack(interop.from_numpy_tree(stack), groups, 0.1,
                           variant, seed=(2, 1))
        _eq_tree(got, want)
    with pytest.raises(ValueError, match="unknown fusion"):
        P.fuse_stack(interop.from_numpy_tree(stack), GROUPS, 0.1, "mean")


def test_transfer_stage_is_exact():
    glob = {"layers": _stack(6), "other": {"w": np.ones((2, 3), np.float32)}}
    sub = {"layers": jax.tree.map(lambda a: a[:3], _stack(7))}
    plan = {"layers": {"groups": GROUPS, "n_layers": 8},
            "missing": {"groups": [[0]], "n_layers": 1}}
    want = J.transfer_stage(jax.tree.map(jnp.asarray, glob),
                            jax.tree.map(jnp.asarray, sub), plan)
    got = P.transfer_stage(interop.from_numpy_tree(glob),
                           interop.from_numpy_tree(sub), plan)
    assert sorted(got) == sorted(want)
    _eq_tree(got, want)
    _eq_tree(P.layer_add(interop.from_numpy_tree(sub),
                         interop.from_numpy_tree(sub)),
             J.layer_add(jax.tree.map(jnp.asarray, sub),
                         jax.tree.map(jnp.asarray, sub)))


# ---------------------------------------------------------------------------
# build_submodel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,n_layers", [("granite-moe-1b-a400m", 6),
                                           ("llama2-7b-proxy", 8)])
@pytest.mark.parametrize("fusion", ["dblf", "rone"])
def test_build_submodel_is_equal(arch, n_layers, fusion, test_spec):
    spec = dataclasses.replace(test_spec, n_layers=n_layers)
    jcfg = jax_reduce_config(jax_get_config(arch), spec)
    pcfg = reduce_config(get_config(arch),
                         ReducedSpec(**dataclasses.asdict(spec)))
    key = jax.random.PRNGKey(3)
    params = jax.tree.map(np.asarray, JT.init_params(jcfg, key, jnp.float32))
    lora = jax.tree.map(np.asarray, JT.init_lora(
        jcfg, jax.random.fold_in(key, 1), rank=4))
    pp, pl = interop.from_numpy_tree(params), interop.from_numpy_tree(lora)
    jp, jl = jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray,
                                                             lora)
    sched = J.make_schedule(n_layers, 4, n_stages=3)
    assert sched.capacities == P.make_schedule(n_layers, 4, 3).capacities
    jctl = J.DevFTController(jcfg, sched, fusion=fusion, seed=5)
    pctl = P.DevFTController(pcfg, sched, fusion=fusion, seed=5)
    for stage in range(sched.n_stages):
        want = jctl.start_stage(jp, jl, stage)
        got = pctl.start_stage(pp, pl, stage)
        w = J.similarity_matrix(J.layer_vectors(jp["blocks"]["layers"],
                                                jl["layers"]))
        assert got.plan == want.plan, (
            "eigen-gap", _eigen_gap(w, min(got.capacity, n_layers - 1)))
        assert got.capacity == want.capacity
        assert shared_fields(got.cfg) == dataclasses.asdict(want.cfg)
        _eq_tree(got.params, want.params)
        _eq_tree(got.lora, want.lora)
        # the trained submodel LoRA goes back to the global tree
        _eq_tree(pctl.finish_stage(pl, got.lora),
                 jctl.finish_stage(jl, want.lora))
