"""The port's train->serve hand-off against the JAX package's
(``tests/test_serving.py::test_registry_from_run_*``): a reduced
qwen2-7b DevFT run with ``export_adapters=True`` on both sides, from the
JAX package's initial params and LoRA crossed through
``repro_torch.interop``, then the registry served by each package's
engine; and the public ``serving.kv_cache.flash_decode`` helper.

* Registry ids and the served tokens: exactly equal.
* ``"global"``: bit-equal to the port's own ``final_lora``.
* Each ``client/<i>`` against JAX's personalized adapter at the
  runner's limits (``tests/test_torch_runner.py``): every element
  within 2·lr·(local steps: the run's and the personalization's), and
  at least 99% of each leaf within rel = abs = 1e-3.
* ``flash_decode`` on the CPU, both backends, against JAX's helper:
  f32 rtol = atol = 1e-6 (the same masked softmax; exp and the sums
  round apart).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.experiments import run_experiment as jax_run_experiment
from repro.experiments.spec import ExperimentSpec as JaxSpec
from repro.models import transformer as JT
from repro.serving import ServingEngine as JaxEngine
from repro.serving import flash_decode as jax_flash_decode
from repro_torch import interop
from repro_torch.experiments import ExperimentSpec, RunResult, run_experiment
from repro_torch.serving import (ServingEngine, flash_decode,
                                 personalized_adapters, registry_from_run)

torch.set_num_threads(1)

SPEC = dict(arch="qwen2-7b", method="devft",
            reduced={"vocab": 64, "d_model": 32}, rounds=2, n_clients=3,
            k_local=2, local_batch=2, seq=16, pretrain_steps=0, seed=0)


@pytest.fixture(scope="module")
def runs():
    """(port result, JAX result, port params, JAX params)."""
    jspec, pspec = JaxSpec(**SPEC), ExperimentSpec(**SPEC)
    assert jspec.spec_hash() == pspec.spec_hash()
    want = jax_run_experiment(jspec, export_adapters=True)
    cfg = jspec.build_cfg()
    key = jax.random.PRNGKey(jspec.seed)
    # the JAX round engine's own init (FederatedRunner: f32 params)
    jparams = JT.init_params(cfg, key, jnp.float32)
    lora = JT.init_lora(cfg, jax.random.fold_in(key, 1),
                        rank=jspec.lora_rank)
    to_port = lambda t: interop.from_numpy_tree(  # noqa: E731
        jax.tree.map(np.asarray, t))
    pparams = to_port(jparams)
    got = run_experiment(pspec, params=pparams, lora=to_port(lora),
                         export_adapters=True, device="cpu")
    return got, want, pparams, jparams


def test_export_gives_the_same_ids(runs):
    got, want, _, _ = runs
    ids = sorted(got.adapter_registry.ids())
    assert ids == sorted(want.adapter_registry.ids())
    assert ids == ["client/0", "client/1", "client/2", "global"]
    assert got.adapter_registry.capacity == want.adapter_registry.capacity


def test_global_is_the_final_lora(runs):
    got, _, _, _ = runs
    g = got.adapter_registry.get("global")
    for (path, a), (_, b) in zip(interop.tree_paths(g),
                                 interop.tree_paths(got.final_lora)):
        assert torch.equal(a, b), path


@pytest.mark.parametrize("client", [0, 1, 2])
def test_personalized_adapter_matches_jax(runs, client):
    got, want, _, _ = runs
    spec = got.spec
    g = got.adapter_registry.get(f"client/{client}")
    w = want.adapter_registry.get(f"client/{client}")
    glob = got.adapter_registry.get("global")
    steps = spec.rounds * spec.k_local + spec.k_local
    differs = False
    for (path, gl), (_, wl), (_, base) in zip(
            interop.tree_paths(g),
            jax.tree_util.tree_flatten_with_path(w)[0],
            interop.tree_paths(glob)):
        gl, wl = gl.numpy(), np.asarray(wl)
        np.testing.assert_allclose(gl, wl, rtol=0, atol=2 * spec.lr * steps,
                                   err_msg=str(path))
        off = ~np.isclose(gl, wl, rtol=1e-3, atol=1e-3)
        assert off.mean() <= 0.01, (path, off.mean())
        differs |= not np.array_equal(gl, base.numpy())
    assert differs, "personalization left the global adapter unchanged"


def test_registry_serves_jax_tokens(runs):
    got, want, pparams, jparams = runs
    cfg = got.spec.build_cfg()
    prompt = np.arange(4, dtype=np.int32)
    eng = ServingEngine(cfg, pparams, adapters=got.adapter_registry,
                        n_slots=2, kv_capacity=8)
    r = eng.submit(prompt, max_new_tokens=4, adapter="client/1")
    jeng = JaxEngine(want.spec.build_cfg(), jparams,
                     adapters=want.adapter_registry, n_slots=2,
                     kv_capacity=8)
    jr = jeng.submit(prompt, max_new_tokens=4, adapter="client/1")
    for e in (eng, jeng):
        while e.has_work():
            e.step()
    assert r.done and len(r.generated) == 4
    assert list(r.generated) == list(jr.generated)


def test_personalized_adapters_direct_call(runs):
    """``personalized_adapters`` alone, with fewer steps: new tensors on
    the params' device, the global adapter untouched."""
    got, _, pparams, _ = runs
    before = interop.tree_map(torch.clone, got.final_lora)
    out = personalized_adapters(got, pparams, k_steps=1)
    assert sorted(out) == [0, 1, 2]
    for (path, a), (_, b) in zip(interop.tree_paths(got.final_lora),
                                 interop.tree_paths(before)):
        assert torch.equal(a, b), path
    reg = registry_from_run(got, pparams, personalize=False)
    assert reg.ids() == ["global"] and reg.capacity == 1


def test_registry_from_run_requires_final_lora():
    res = RunResult(spec=ExperimentSpec(), logs=[], wall_s=0.0, metrics={})
    with pytest.raises(ValueError):
        registry_from_run(res, params=None)
    with pytest.raises(ValueError):
        personalized_adapters(res, params=None)


@pytest.mark.parametrize("backend", ["reference", "auto", "pallas"])
@pytest.mark.parametrize("shape", [(2, 7, 4, 2, 8), (3, 16, 8, 1, 16)])
def test_kv_cache_flash_decode_matches_jax(backend, shape):
    b, c, h, hkv, hd = shape
    rng = np.random.default_rng(np.random.SeedSequence((21, c)))
    q = rng.standard_normal((b, 1, h, hd), dtype=np.float32)
    k = rng.standard_normal((b, c, hkv, hd), dtype=np.float32)
    v = rng.standard_normal((b, c, hkv, hd), dtype=np.float32)
    valid = rng.integers(0, c + 1, size=b).astype(np.int32)
    valid[0] = c
    want = np.asarray(jax_flash_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        kv_valid_len=jnp.asarray(valid), scale=0.3))
    got = flash_decode(*(torch.from_numpy(a) for a in (q, k, v)),
                       kv_valid_len=torch.from_numpy(valid), scale=0.3,
                       backend=backend)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        flash_decode(torch.from_numpy(q), torch.from_numpy(k),
                     torch.from_numpy(v),
                     kv_valid_len=torch.from_numpy(valid), backend="tpu")
