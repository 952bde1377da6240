"""The PyTorch port's MoE decoding (``decode_step`` on ``gqa_moe``
blocks) against the JAX package, on reduced granite-moe-1b-a400m (d 128,
4 heads of 32 over 2 kv heads, 4 experts top 2 of width 128), f32.

At decode the MoE block routes the (B, d) tokens of one step, so its
capacity is ``_capacity(cfg, B)``: 8 rows at B = 8 for both the reduced
config and full granite (8·8/32·1.25 rounds up to 8).

* Routing at T = B, layer by layer: the top-k experts, each slot's
  position and keep mask, and each expert's fill exactly equal to the
  JAX package's (its fill is the count of kept slots per expert). At
  B <= 8 no slot can drop; a pool of 32 at capacity factor 0.5 drops
  slots in both alike.
* ``decode_step`` teacher-forced over S + G steps, 2-D and per-slot
  LoRA: logits within rel = abs = 1e-4 (``test_torch_model.py``'s f32
  limit), then the whole cache.
* The engine with two adapters and more requests than slots (inactive
  lanes route their tokens too, as in the JAX package): greedy tokens
  exactly equal to the JAX engine's.
* The kernel branch forced on the CPU (``dispatch.use_kernel`` true in
  ``models/moe.py``, so the expert FFN runs through the
  ``moe_expert_ffn`` autograd Function) at C = 8 against the JAX
  package's ``moe_expert_ffn_ecd`` Pallas kernel in interpret mode, at
  ``test_torch_moe.py``'s f32 limit of 1e-5; the block passes the fill.
* The train->serve hand-off: a ``bench-tiny`` DevFT run's ``global``
  adapter served by each package's engine from its own run gives the
  same tokens.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduce_config as jax_reduce_config
from repro.experiments import get_preset as jax_get_preset
from repro.experiments import run_experiment as jax_run_experiment
from repro.experiments.runner import pretrained_base as jax_pretrained_base
from repro.models import moe as JM
from repro.models import transformer as JT
from repro.serving import AdapterRegistry as JaxRegistry
from repro.serving import ServingEngine as JaxEngine
from repro.serving import registry_from_run as jax_registry_from_run
from repro_torch import interop
from repro_torch.configs import ReducedSpec, get_config, reduce_config
from repro_torch.experiments import get_preset, run_experiment
from repro_torch.models import moe as PM
from repro_torch.models import transformer as PT
from repro_torch.serving import (AdapterRegistry, ServingEngine,
                                 registry_from_run)

torch.set_num_threads(1)

ARCH = "granite-moe-1b-a400m"
F32_TOL = 1e-4
FFN_TOL = 1e-5


def _cfgs(test_spec, backend="reference", capacity_factor=1.25):
    jcfg = jax_reduce_config(jax_get_config(ARCH), test_spec)
    pcfg = reduce_config(get_config(ARCH),
                         ReducedSpec(**dataclasses.asdict(test_spec)))
    return tuple(
        dataclasses.replace(cfg, dtype="float32", kernel_backend=kb,
                            moe=dataclasses.replace(
                                cfg.moe, capacity_factor=capacity_factor))
        for cfg, kb in ((jcfg, backend), (pcfg, "reference")))


def _rng(*key):
    return np.random.default_rng(np.random.SeedSequence(
        [sum(map(ord, str(k))) for k in key]))


def _params(jcfg):
    return jax.tree.map(np.asarray, JT.init_params(
        jcfg, jax.random.PRNGKey(0), jnp.float32))


def _lora(jcfg, rng, *, batch=None, rank=4):
    tmpl = JT.init_lora(jcfg, jax.random.PRNGKey(1), rank=rank)

    def one(a):
        shape = a.shape if batch is None else (a.shape[0], batch) + a.shape[1:]
        return (0.05 * rng.standard_normal(shape)).astype(np.float32)
    return jax.tree.map(one, tmpl)


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def test_decode_capacity_at_granite_width():
    full = get_config(ARCH)
    assert PM._capacity(full, 8) == JM._capacity(jax_get_config(ARCH), 8) == 8
    # a token takes an expert at most once, so at B = 8 an expert gets at
    # most 8 slots: none drops
    x = torch.randn(8, full.d_model)
    router = {"router": torch.randn(full.d_model, full.moe.n_experts)}
    _, idx, _ = PM.router_topk(router, full, x)
    _, keep, fill = PM._dispatch_indices(idx.reshape(-1),
                                         full.moe.n_experts, 8)
    assert bool(keep.all()) and int(fill.sum()) == 8 * full.moe.top_k
    for t in (1, 4, 16, 64):
        assert PM._capacity(full, t) == JM._capacity(jax_get_config(ARCH), t)


@pytest.mark.parametrize("b,capacity_factor,cap", [
    (8, 1.25, 8), (3, 1.25, 8), (32, 0.5, 8)])
def test_routing_at_decode_is_exactly_equal(b, capacity_factor, cap,
                                            test_spec):
    """At B <= 8 no slot can drop (a token takes an expert once, and the
    capacity is at least 8); a pool of 32 slots at capacity factor 0.5
    drops slots, in both packages alike."""
    jcfg, pcfg = _cfgs(test_spec, capacity_factor=capacity_factor)
    rng = _rng("routing", b)
    ffn = _params(jcfg)["blocks"]["layers"]["ffn"]
    assert PM._capacity(pcfg, b) == JM._capacity(jcfg, b) == cap
    dropped = 0
    for layer in range(pcfg.n_layers):
        router = np.array(ffn["router"][layer])
        for _ in range(4):
            x = rng.standard_normal((b, jcfg.d_model)).astype(np.float32)
            _, jidx, _ = JM.router_topk({"router": jnp.asarray(router)}, jcfg,
                                        jnp.asarray(x))
            _, pidx, _ = PM.router_topk({"router": torch.from_numpy(router)},
                                        pcfg, torch.from_numpy(x))
            np.testing.assert_array_equal(pidx.numpy(), np.asarray(jidx))
            flat = np.array(jidx).reshape(-1)
            jpos, jkeep = JM._dispatch_indices(jnp.asarray(flat),
                                               jcfg.moe.n_experts, cap)
            ppos, pkeep, pfill = PM._dispatch_indices(
                torch.from_numpy(flat).long(), pcfg.moe.n_experts, cap)
            np.testing.assert_array_equal(ppos.numpy(), np.asarray(jpos))
            np.testing.assert_array_equal(pkeep.numpy(), np.asarray(jkeep))
            want_fill = np.bincount(flat[np.asarray(jkeep)],
                                    minlength=jcfg.moe.n_experts)
            assert pfill.dtype == torch.int32
            np.testing.assert_array_equal(pfill.numpy(), want_fill)
            dropped += int((~np.asarray(jkeep)).sum())
    assert (dropped > 0) == (b > cap)


@pytest.mark.parametrize("lora_mode", ["2d", "per-slot"])
def test_decode_step_teacher_forced_matches_jax(lora_mode, test_spec):
    jcfg, pcfg = _cfgs(test_spec)
    rng = _rng("teacher", lora_mode)
    b, s, g = 8, 6, 5
    params = _params(jcfg)
    lora = _lora(jcfg, rng, batch=b if lora_mode == "per-slot" else None)
    tokens = rng.integers(0, jcfg.vocab, (b, s + g)).astype(np.int32)
    jc = JT.init_cache(jcfg, b, s + g, jnp.float32)
    pc = PT.init_cache(pcfg, b, s + g, torch.float32, "cpu")
    step = jax.jit(lambda p, l, tok, c: JT.decode_step(jcfg, p, l, tok, c))
    jp, jl = jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray,
                                                             lora)
    pp, pl = interop.from_numpy_tree(params), interop.from_numpy_tree(lora)
    for i in range(s + g):
        tok = tokens[:, i:i + 1]
        jlog, jc = step(jp, jl, jnp.asarray(tok), jc)
        plog, pc = PT.decode_step(pcfg, pp, pl, torch.from_numpy(tok), pc)
        assert tuple(plog.shape) == jlog.shape
        _close(plog[..., :jcfg.vocab], np.asarray(jlog)[..., :jcfg.vocab],
               F32_TOL)
    np.testing.assert_array_equal(pc["pos"].numpy(), np.asarray(jc["pos"]))
    for (_, got), want in zip(interop.tree_paths(pc["stacks"]),
                              jax.tree.leaves(jc["stacks"])):
        _close(got, want, F32_TOL)


def test_engine_tokens_equal_jax_with_recycling(test_spec):
    jcfg, pcfg = _cfgs(test_spec)
    rng = _rng("engine")
    params = _params(jcfg)
    adapters = [_lora(jcfg, rng) for _ in range(2)]
    prompts = [rng.integers(0, jcfg.vocab, n).astype(np.int32)
               for n in (5, 3, 7, 4, 6)]
    gen = 5
    toks = []
    for cfg, conv, Engine, Registry in (
            (jcfg, lambda t: jax.tree.map(jnp.asarray, t), JaxEngine,
             JaxRegistry),
            (pcfg, interop.from_numpy_tree, ServingEngine, AdapterRegistry)):
        reg = Registry(conv(adapters[0]), capacity=2)
        for i, a in enumerate(adapters):
            reg.add(f"a{i}", conv(a))
        eng = Engine(cfg, conv(params), adapters=reg, n_slots=2,
                     kv_capacity=12)
        reqs = [eng.submit(p, max_new_tokens=gen, adapter=f"a{i % 2}")
                for i, p in enumerate(prompts)]
        while eng.has_work():
            eng.step()
        toks.append([r.tokens for r in reqs])
    for jt, pt in zip(*toks):
        assert len(pt) == gen
        np.testing.assert_array_equal(pt, jt)


def test_forced_kernel_branch_at_decode_capacity_matches_jax_pallas(
        test_spec, monkeypatch):
    """One decode step's MoE block at B = 8 (capacity 8): the port's
    kernel branch (on the CPU the ``moe_expert_ffn`` Function's plain
    version, with the fill) against JAX's Pallas kernel in interpret
    mode."""
    jcfg, pcfg = _cfgs(test_spec, backend="pallas")
    rng = _rng("kernel_branch")
    ffn = jax.tree.map(lambda a: a[0],
                       _params(jcfg)["blocks"]["layers"]["ffn"])
    x = rng.standard_normal((8, jcfg.d_model)).astype(np.float32)
    want, _ = JM.moe_block(jax.tree.map(jnp.asarray, ffn), jcfg,
                           jnp.asarray(x))
    calls = []
    real = PM.ops.moe_expert_ffn

    def spy(buf, *a, **kw):
        calls.append((tuple(buf.shape), kw["fill"].tolist()))
        return real(buf, *a, **kw)
    monkeypatch.setattr(PM.ops, "moe_expert_ffn", spy)
    monkeypatch.setattr(PM, "dispatch",
                        types.SimpleNamespace(use_kernel=lambda *a: True))
    pcfg_k = dataclasses.replace(pcfg, kernel_backend="auto")
    got, _ = PM.moe_block(interop.from_numpy_tree(ffn), pcfg_k,
                          torch.from_numpy(x))
    e = pcfg.moe.n_experts
    assert len(calls) == 1 and calls[0][0] == (e, 8, pcfg.d_model)
    assert sum(calls[0][1]) <= 8 * pcfg.moe.top_k
    assert all(0 <= f <= 8 for f in calls[0][1])
    _close(got, want, FFN_TOL)


@pytest.fixture(scope="module")
def handoff():
    """A bench-tiny DevFT run of reduced granite in both packages, from
    the JAX package's pretrained base and initial LoRA."""
    kw = {"arch": ARCH, "method": "devft"}
    jspec, pspec = jax_get_preset("bench-tiny").replace(**kw), \
        get_preset("bench-tiny").replace(**kw)
    assert jspec.spec_hash() == pspec.spec_hash()
    want = jax_run_experiment(jspec)
    jparams, _ = jax_pretrained_base(jspec)
    lora = JT.init_lora(jspec.build_cfg(),
                        jax.random.fold_in(jax.random.PRNGKey(jspec.seed), 1),
                        rank=jspec.lora_rank)
    to_port = lambda t: interop.from_numpy_tree(  # noqa: E731
        jax.tree.map(np.asarray, t))
    pparams = to_port(jparams)
    got = run_experiment(pspec, params=pparams, lora=to_port(lora),
                         device="cpu")
    return got, want, pparams, jparams


def test_handoff_global_adapter_serves_jax_tokens(handoff):
    got, want, pparams, jparams = handoff
    preg = registry_from_run(got, pparams, personalize=False)
    jreg = jax_registry_from_run(want, jparams, personalize=False)
    assert preg.ids() == jreg.ids() == ["global"]
    rng = _rng("handoff")
    cfg = got.spec.build_cfg()
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in (6, 4, 5)]
    toks = []
    for c, params, reg, Engine in (
            (cfg, pparams, preg, ServingEngine),
            (want.spec.build_cfg(), jparams, jreg, JaxEngine)):
        eng = Engine(c, params, adapters=reg, n_slots=2, kv_capacity=12)
        reqs = [eng.submit(p, max_new_tokens=6, adapter="global")
                for p in prompts]
        while eng.has_work():
            eng.step()
        toks.append([list(r.generated) for r in reqs])
    assert all(len(t) == 6 for t in toks[0])
    assert toks[0] == toks[1]
