"""The port's multi-device paths over ``gloo`` process groups on the CPU,
against the JAX package.

Every process group lives in spawned rank processes
(``tests/torch_mesh_worker.py``): one world of 1 rank (the 1x1 mesh),
one of 2 (a 1x2 and a 2x1 mesh) and one of 4 (2x2), all started once
for the module. The JAX side is one subprocess with 4 host devices,
run beside them: the bench-tiny base the port's runs start from, JAX's
``moe_block_ep`` on each mesh shape, then JAX's ``mesh=None`` runs.

* ``moe_block_ep`` on the (data, model) meshes 1x1, 1x2 and 2x2 against
  JAX's ``moe_block_ep`` on meshes of the same shapes: y, aux, the
  gradients of x and of the expert weights (summed over the ranks, as
  a data-parallel optimizer does), at rel 1e-5 of each array's largest
  magnitude (the all-reduce only reorders a sum); x is skewed towards
  one expert, so slots drop past the local capacity.
* On the 1x1 mesh: the model's ``gather_sharded`` path and its params
  placed as DTensors give the plain ``gather`` path's loss and LoRA
  gradients exactly (and ``ep`` the same bits placed or not); prefill
  too.
* The round engine: ``mesh="host"`` bench-tiny runs (DevFT and FedIT,
  from the JAX package's pretrained base and LoRA) bit-identical to the
  port's own ``mesh=None`` runs, final LoRA included, and those within
  the trajectory limits of a live JAX ``mesh=None`` run; a 2-rank run on
  a 2x1 mesh (the sampled clients split over ``data``), DevFT and a
  heterogeneous-fleet FedIT, the same ``RoundLog``s and final LoRA as
  ``mesh=None``.
"""
import json
import os
import pickle
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from repro.experiments import get_preset as jax_get_preset
from repro_torch.experiments import get_preset
from test_torch_runner import FLOAT_FIELDS, INT_FIELDS
from torch_mesh_worker import EP_REDUCED, ep_cfg, join_world, start_world

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EP_SHAPES = ((1, 1), (1, 2), (2, 2))
EP_TOKENS = 32
EP_REL = 1e-5

#: the JAX side, one subprocess with 4 host devices: first the
#: bench-tiny base (pretrained params, initial LoRA) the port's runs
#: start from, then ``moe_block_ep`` on each mesh shape, then the live
#: ``mesh=None`` bench-tiny runs
_JAX = r"""
import dataclasses, json, os, pickle, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config, reduce_config
from repro.configs.base import ReducedSpec
from repro.experiments import get_preset, run_experiment
from repro.experiments.runner import pretrained_base
from repro.models import moe as M, transformer as T

tmp, reduced, shapes = sys.argv[1], json.loads(sys.argv[2]), \
    json.loads(sys.argv[3])
as_np = lambda t: jax.tree.map(np.asarray, t)


def dump(obj, name):
    with open(os.path.join(tmp, name + ".part"), "wb") as f:
        pickle.dump(obj, f)
    os.replace(os.path.join(tmp, name + ".part"), os.path.join(tmp, name))


spec = get_preset("bench-tiny")
params, _ = pretrained_base(spec)
lora = T.init_lora(spec.build_cfg(),
                   jax.random.fold_in(jax.random.PRNGKey(spec.seed), 1),
                   rank=spec.lora_rank)
dump({"params": as_np(params), "lora": as_np(lora)}, "jax_base.pkl")

inp = np.load(os.path.join(tmp, "ep_in.npz"))
cfg = reduce_config(get_config("granite-moe-1b-a400m"), ReducedSpec(**reduced))
p = {k: jnp.asarray(inp[k]) for k in ("router", "wg", "wu", "wd")}
x, g = jnp.asarray(inp["x"]), jnp.asarray(inp["g"])
ep = {}
for dp, tp in shapes:
    mesh = jax.make_mesh((dp, tp), ("data", "model"),
                         devices=jax.devices()[:dp * tp])

    def loss(x, wg, wu, wd):
        y, aux = M.moe_block_ep(dict(p, wg=wg, wu=wu, wd=wd), cfg, x,
                                mesh=mesh)
        return jnp.sum(y * g) + aux, (y, aux)

    (_, (y, aux)), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2, 3), has_aux=True))(x, p["wg"], p["wu"],
                                                   p["wd"])
    ep[(dp, tp)] = dict(zip(("y", "aux", "dx", "dwg", "dwu", "dwd"),
                            as_np((y, aux) + grads)))

runs = {}
for method in ("devft", "fedit"):
    res = run_experiment(spec.replace(method=method))
    runs[method] = ([dataclasses.asdict(log) for log in res.logs],
                    as_np(res.final_lora))
dump({"ep": ep, "runs": runs}, "jax_out.pkl")
"""


def _ep_inputs():
    """Expert weights, tokens skewed towards expert 0 (so it gets more
    slots than the local capacity) and the loss's weights g, f32."""
    rng = np.random.default_rng(np.random.SeedSequence((26, 1)))
    d, e = EP_REDUCED["d_model"], EP_REDUCED["n_experts"]
    ff = ep_cfg().moe.d_ff_expert

    def normal(shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    params = {"router": normal((d, e), d ** -0.5),
              "wg": normal((e, d, ff), d ** -0.5),
              "wu": normal((e, d, ff), d ** -0.5),
              "wd": normal((e, ff, d), ff ** -0.5)}
    r0 = params["router"][:, 0]
    x = normal((EP_TOKENS, d), 1.0) + 2.0 * r0 / np.linalg.norm(r0) ** 2
    return params, x.astype(np.float32), normal((EP_TOKENS, d), 1.0)


ROUND_SPECS = {
    "devft": get_preset("bench-tiny").replace(pretrain_steps=0, rounds=4),
    "fedit-hetero": get_preset("bench-tiny").replace(
        method="fedit", pretrain_steps=0, rounds=2,
        population="pareto-edge", weighting="examples",
        deadline_factor=1.5),
}


def _wait_for(path, proc, timeout=240.0):
    t0 = time.monotonic()
    while not os.path.exists(path):
        assert proc.poll() is None, f"the JAX subprocess exited {proc.poll()}"
        assert time.monotonic() - t0 < timeout, f"no {path}"
        time.sleep(0.1)
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("mesh"))
    params, x, g = _ep_inputs()
    np.savez(os.path.join(tmp, "ep_in.npz"), x=x, g=g, **params)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    with open(os.path.join(tmp, "jax.log"), "w") as log:
        jax_proc = subprocess.Popen(
            [sys.executable, "-c", _JAX, tmp, json.dumps(EP_REDUCED),
             json.dumps(EP_SHAPES)], env=env, cwd=ROOT, stdout=log,
            stderr=subprocess.STDOUT)
    try:
        ep = {"x": x, "g": g, "params": params}
        rounds = {k: v.to_dict() for k, v in ROUND_SPECS.items()}
        two = start_world(2, [("ep", dict(ep, shape=(1, 2))),
                              ("round", rounds)], tmp)
        four = start_world(4, [("ep", dict(ep, shape=(2, 2)))], tmp)
        base = _wait_for(os.path.join(tmp, "jax_base.pkl"), jax_proc)
        host = {m: dict(base, spec=get_preset("bench-tiny").replace(
            method=m).to_dict()) for m in ("devft", "fedit")}
        one = start_world(1, [("ep", dict(ep, shape=(1, 1))),
                              ("host", {"runs": host})], tmp)
        got = {1: join_world(one, tmp), 2: join_world(two, tmp),
               4: join_world(four, tmp)}
        want = _wait_for(os.path.join(tmp, "jax_out.pkl"), jax_proc)
        assert jax_proc.wait(timeout=60) == 0
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
    return {"ranks": got, "jax_ep": want["ep"], "jax_runs": want["runs"]}


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=EP_REL,
                               atol=EP_REL * np.abs(want).max(), err_msg=what)


@pytest.mark.parametrize("shape", EP_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_moe_block_ep_matches_jax(results, shape):
    dp, tp = shape
    ranks = [r["ep"] for r in results["ranks"][dp * tp]]
    want = results["jax_ep"][shape]
    by_coord = {r["coord"]: r for r in ranks}
    assert sorted(by_coord) == [(d, m) for d in range(dp) for m in range(tp)]
    for d in range(dp):
        # every rank of the model axis holds the same output and token
        # gradient: the sum's result and the gradient's sum
        for m in range(1, tp):
            for key in ("y", "dx"):
                np.testing.assert_array_equal(by_coord[(d, m)][key],
                                              by_coord[(d, 0)][key])
            assert by_coord[(d, m)]["aux"] == by_coord[(d, 0)]["aux"]
    for key in ("y", "dx"):
        _close(np.concatenate([by_coord[(d, 0)][key] for d in range(dp)]),
               want[key], f"{shape} {key}")
    _close(ranks[0]["aux"], want["aux"], f"{shape} aux")
    for key in ("dwg", "dwu", "dwd"):
        _close(sum(r[key] for r in ranks), want[key], f"{shape} {key}")
    assert sum(r["drops"] for r in ranks) > 0, "no slot dropped"


def test_gather_sharded_and_placed_params_equal_gather(results):
    host = results["ranks"][1][0]["host"]
    assert host["placed_types"] == ["DTensor"]
    loss, grads = host["grads"]["gather"]
    for tag in ("gather_sharded", "placed"):
        got_loss, got = host["grads"][tag]
        assert got_loss == loss, tag
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(grads)):
            np.testing.assert_array_equal(a, b, err_msg=tag)
    ep_loss, ep = host["grads"]["ep"]
    assert host["grads"]["placed ep"][0] == ep_loss
    for a, b in zip(jax.tree.leaves(host["grads"]["placed ep"][1]),
                    jax.tree.leaves(ep)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(host["prefill"]["placed"],
                                  host["prefill"]["plain"])


def _assert_same_run(got, want, what):
    (glogs, glora), (wlogs, wlora) = got, want
    assert glogs == wlogs, what
    assert jax.tree.structure(glora) == jax.tree.structure(wlora), what
    for a, b in zip(jax.tree.leaves(glora), jax.tree.leaves(wlora)):
        np.testing.assert_array_equal(a, b, err_msg=what)


@pytest.mark.parametrize("method", ["devft", "fedit"])
def test_host_mesh_round_matches_unsharded_and_jax(results, method):
    assert get_preset("bench-tiny").replace(method=method).spec_hash() \
        == jax_get_preset("bench-tiny").replace(method=method).spec_hash()
    runs = results["ranks"][1][0]["host"]["runs"]
    _assert_same_run(runs[(method, "host")], runs[(method, None)], method)
    logs, lora = runs[(method, None)]
    want_logs, want_lora = results["jax_runs"][method]
    assert len(logs) == len(want_logs) == 6
    for g, w in zip(logs, want_logs):
        for f in INT_FIELDS:
            assert g[f] == w[f], (f, g, w)
        for f in FLOAT_FIELDS:
            assert g[f] == pytest.approx(w[f], rel=1e-3, abs=1e-3), (f, g, w)
    # the final LoRA at the runner tests' limits (test_torch_runner.py)
    spec = get_preset("bench-tiny")
    assert jax.tree.structure(lora) == jax.tree.structure(want_lora)
    for g, w in zip(jax.tree.leaves(lora), jax.tree.leaves(want_lora)):
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=2 * spec.lr * spec.rounds
                                   * spec.k_local)
        assert (~np.isclose(g, w, rtol=1e-3, atol=1e-3)).mean() <= 0.01


@pytest.mark.parametrize("name", list(ROUND_SPECS))
def test_two_rank_round_matches_unsharded(results, name):
    r0, r1 = (r["round"] for r in results["ranks"][2])
    want = r0[(name, False)]
    assert len(want[0]) == ROUND_SPECS[name].rounds
    _assert_same_run(r0[(name, True)], want, f"{name} rank 0")
    _assert_same_run(r1[(name, True)], want, f"{name} rank 1")
