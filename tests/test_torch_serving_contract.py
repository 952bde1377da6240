"""The serving step's contract in the port: ``ServingEngine`` declares a
``StepContract``, and its step returns int32 next tokens, as the JAX
package's step does (``jnp.argmax(...).astype(jnp.int32)``).

The same params (made by the JAX package, moved through
``repro_torch.interop``) and the same prompts go through both engines,
reduced qwen2-7b in f32; every step's next-token vector is recorded on
both sides and must have the same dtype and the same values.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduce_config as jax_reduce_config
from repro.models import transformer as JT
from repro.serving import AdapterRegistry as JaxRegistry
from repro.serving import ServingEngine as JaxEngine
from repro_torch import interop
from repro_torch.analysis.contracts.serving import (MODES,
                                                    check_step_contract,
                                                    make_engine)
from repro_torch.configs import ReducedSpec, get_config, reduce_config
from repro_torch.serving import AdapterRegistry, ServingEngine
from repro_torch.serving.engine import StepContract

pytestmark = pytest.mark.analysis

torch.set_num_threads(1)

S, G = 5, 4          # prompt / generated lengths


@pytest.fixture(scope="module")
def model(test_spec):
    """(jax cfg, port cfg, numpy params, numpy adapters a0, a1)."""
    jcfg = jax_reduce_config(jax_get_config("qwen2-7b"), test_spec)
    pcfg = reduce_config(get_config("qwen2-7b"), ReducedSpec(**{
        f: getattr(test_spec, f) for f in test_spec.__dataclass_fields__}))
    params = jax.tree.map(np.asarray, JT.init_params(
        jcfg, jax.random.PRNGKey(0), jnp.float32))
    tmpl = JT.init_lora(jcfg, jax.random.PRNGKey(1), rank=4)
    rngs = [np.random.default_rng(np.random.SeedSequence((5, i)))
            for i in range(2)]
    loras = [jax.tree.map(lambda a, r=r: (0.05 * r.standard_normal(a.shape)
                                          ).astype(np.float32), tmpl)
             for r in rngs]
    return jcfg, pcfg, params, loras


def _recorded_tokens(jcfg, pcfg, params, loras, prompts, n_slots):
    """Both engines, multi-tenant, the same requests: every step's next
    tokens, (JAX's, the port's)."""
    jreg = JaxRegistry(jax.tree.map(jnp.asarray, loras[0]), capacity=2)
    preg = AdapterRegistry(interop.from_numpy_tree(loras[0]), capacity=2)
    for i, a in enumerate(loras):
        jreg.add(f"a{i}", jax.tree.map(jnp.asarray, a))
        preg.add(f"a{i}", interop.from_numpy_tree(a))
    jeng = JaxEngine(jcfg, jax.tree.map(jnp.asarray, params), adapters=jreg,
                     n_slots=n_slots, kv_capacity=S + G)
    peng = ServingEngine(pcfg, interop.from_numpy_tree(params),
                         adapters=preg, n_slots=n_slots, kv_capacity=S + G)
    got = {"jax": [], "port": []}
    jstep, pstep = jeng._step_fn, peng._step

    def jax_step(*args):
        nxt, cache = jstep(*args)
        got["jax"].append(np.asarray(nxt))
        return nxt, cache

    def port_step(*args):
        nxt = pstep(*args)
        got["port"].append(nxt)
        return nxt

    jeng._step_fn, peng._step = jax_step, port_step
    adapters = [f"a{i % 2}" for i in range(len(prompts))]
    jeng.run(list(prompts), max_new_tokens=G, adapter=adapters)
    peng.run(list(prompts), max_new_tokens=G, adapter=adapters)
    return got["jax"], got["port"]


def test_engine_declares_step_contract():
    assert isinstance(ServingEngine.contract, StepContract)
    assert ServingEngine.contract == StepContract(next_tokens_dtype="int32",
                                                  donated="cache")


def test_next_tokens_int32_and_equal_to_jax(model):
    jcfg, pcfg, params, loras = model
    rng = np.random.default_rng(np.random.SeedSequence((11, 3)))
    prompts = rng.integers(0, jcfg.vocab, size=(3, S), dtype=np.int32)
    jtoks, ptoks = _recorded_tokens(jcfg, pcfg, params, loras, prompts,
                                    n_slots=2)
    assert len(jtoks) == len(ptoks) > S      # admission, recycling, decode
    for j, p in zip(jtoks, ptoks):
        assert j.dtype == np.int32
        assert p.dtype == torch.int32 and p.shape == (2,)
        np.testing.assert_array_equal(p.numpy(), j)


@pytest.mark.parametrize("mode", MODES)
def test_step_contract_holds_on_a_cpu_engine(model, mode):
    engine = make_engine(model[1], mode, "cpu")
    pos = engine.kv.cache["pos"].clone()
    assert check_step_contract(engine) == []
    assert torch.equal(engine.kv.cache["pos"], pos)   # every slot masked
