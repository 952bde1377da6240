"""The PyTorch port's serving stack against the JAX package's.

The same params and adapters (made by the JAX package, moved through
numpy) and the same prompts go through both ``ServingEngine``s; greedy
tokens must be equal, in f32, for the scenarios of
``tests/test_serving.py``: shared LoRA, merged weights, multi-tenant
with two adapters, mid-decode admission, slot recycling and the ring
buffer across its wrap. (The logits of the step both engines run are
compared, at 1e-4, by ``tests/test_torch_model.py``.) The scheduler,
adapter registry, KV-cache manager and capacity contract are held to
the JAX package's own tests, and the serve CLI runs to its end on the
CPU.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduce_config as jax_reduce_config
from repro.lora.lora import merge_lora as jax_merge_lora
from repro.models import transformer as JT
from repro.serving import AdapterRegistry as JaxRegistry
from repro.serving import ServingEngine as JaxEngine
from repro_torch import interop
from repro_torch.configs import ReducedSpec, get_config, reduce_config
from repro_torch.launch.serve import generate
from repro_torch.lora.lora import merge_lora
from repro_torch.models import transformer as PT
from repro_torch.serving import (AdapterRegistry, KVCacheManager, Request,
                                 RequestState, ServingEngine, SlotScheduler,
                                 check_capacity, flash_decode)

torch.set_num_threads(1)

S, G = 5, 6          # prompt/gen lengths of tests/test_serving.py
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def model(test_spec):
    """(jax cfg, port cfg, numpy params, numpy adapters l0, l1, shared)."""
    jcfg = jax_reduce_config(jax_get_config("qwen2-7b"), test_spec)
    pcfg = reduce_config(get_config("qwen2-7b"), ReducedSpec(**{
        f: getattr(test_spec, f) for f in test_spec.__dataclass_fields__}))
    params = jax.tree.map(np.asarray, JT.init_params(
        jcfg, jax.random.PRNGKey(0), jnp.float32))
    tmpl = JT.init_lora(jcfg, jax.random.PRNGKey(0), rank=4)
    rngs = [np.random.default_rng(np.random.SeedSequence((7, i)))
            for i in range(3)]
    loras = [jax.tree.map(lambda a, r=r: (0.05 * r.standard_normal(a.shape)
                                          ).astype(np.float32), tmpl)
             for r in rngs]
    return jcfg, pcfg, params, loras


def _prompts(cfg, n, key=0):
    rng = np.random.default_rng(np.random.SeedSequence((11, key)))
    return rng.integers(0, cfg.vocab, size=(n, S), dtype=np.int32)


def _jax(tree):
    return None if tree is None else jax.tree.map(jnp.asarray, tree)


def _port(tree):
    return None if tree is None else interop.from_numpy_tree(tree)


def _drain(engine):
    while engine.has_work():
        engine.step()


def _engines(model, *, lora=None, adapters=(), n_slots=2, cap=S + G,
             overflow="error", merged=False):
    """The same engine in both packages (adapters registered as a0, a1, ...)."""
    jcfg, pcfg, params, _ = model
    jp, pp = _jax(params), _port(params)
    if merged:
        jp = jax_merge_lora(jp, _jax(lora))
        pp = merge_lora(pp, _port(lora))
        lora = None
    out = []
    for cfg, p, conv, Engine, Registry in (
            (jcfg, jp, _jax, JaxEngine, JaxRegistry),
            (pcfg, pp, _port, ServingEngine, AdapterRegistry)):
        reg = None
        if adapters:
            reg = Registry(conv(adapters[0]), capacity=len(adapters))
            for i, a in enumerate(adapters):
                reg.add(f"a{i}", conv(a))
        out.append(Engine(cfg, p, lora=conv(lora), adapters=reg,
                          n_slots=n_slots, kv_capacity=cap,
                          overflow=overflow))
    return out


def _same_tokens(jreqs, preqs):
    for jr, pr in zip(jreqs, preqs):
        np.testing.assert_array_equal(pr.tokens, jr.tokens)
        assert pr.done and len(pr.tokens) == G


# ---------------------------------------------------------------------------
# engine parity with the JAX engine
# ---------------------------------------------------------------------------


def test_engine_shared_lora_matches_jax(model):
    jeng, peng = _engines(model, lora=model[3][2])
    prompts = _prompts(model[0], 2)
    jreqs = [jeng.submit(p, max_new_tokens=G) for p in prompts]
    preqs = [peng.submit(p, max_new_tokens=G) for p in prompts]
    _drain(jeng)
    _drain(peng)
    _same_tokens(jreqs, preqs)
    # and the port's own sequential oracle agrees
    _, pcfg, params, loras = model
    ref = np.stack([t[:, 0].numpy() for t, _ in generate(
        pcfg, _port(params), _port(loras[2]), torch.from_numpy(prompts), G,
        warmup=False)], axis=1)
    np.testing.assert_array_equal(np.stack([r.tokens for r in preqs]), ref)


def test_engine_merged_matches_jax(model):
    jeng, peng = _engines(model, lora=model[3][2], merged=True)
    prompts = _prompts(model[0], 2, key=1)
    jreqs = [jeng.submit(p, max_new_tokens=G) for p in prompts]
    preqs = [peng.submit(p, max_new_tokens=G) for p in prompts]
    _drain(jeng)
    _drain(peng)
    _same_tokens(jreqs, preqs)


@pytest.mark.parametrize("mid_decode", [False, True],
                         ids=["concurrent", "mid-decode-admission"])
def test_multi_tenant_matches_jax(model, mid_decode):
    """Two adapters in flight at once; with ``mid_decode`` the second
    request is admitted while the first is already decoding."""
    jeng, peng = _engines(model, adapters=model[3][:2])
    prompts = _prompts(model[0], 2, key=2)
    reqs = []
    for eng in (jeng, peng):
        eng.warmup()
        ra = eng.submit(prompts[0], max_new_tokens=G, adapter="a0")
        if mid_decode:
            for _ in range(S + 2):
                eng.step()
            assert ra.state.value == RequestState.DECODE.value
        rb = eng.submit(prompts[1], max_new_tokens=G, adapter="a1")
        _drain(eng)
        reqs.append([ra, rb])
    _same_tokens(*reqs)
    assert not np.array_equal(reqs[1][0].tokens, reqs[1][1].tokens)


def test_slot_recycling_matches_jax(model):
    jeng, peng = _engines(model, lora=model[3][2])
    prompts = _prompts(model[0], 5, key=3)
    jreqs = [jeng.submit(p, max_new_tokens=G) for p in prompts]
    preqs = [peng.submit(p, max_new_tokens=G) for p in prompts]
    _drain(jeng)
    _drain(peng)
    _same_tokens(jreqs, preqs)


def test_ring_wrap_matches_jax(model):
    """Capacity below prompt + gen: both cursors cross the wrap, at
    staggered steps (the second request is admitted late)."""
    cap = S + G - 4
    jeng, peng = _engines(model, lora=model[3][2], cap=cap, overflow="ring")
    prompts = _prompts(model[0], 2, key=4)
    reqs = []
    for eng in (jeng, peng):
        r0 = eng.submit(prompts[0], max_new_tokens=G)
        for _ in range(3):
            eng.step()
        r1 = eng.submit(prompts[1], max_new_tokens=G)
        _drain(eng)
        reqs.append([r0, r1])
        assert eng.kv.positions().tolist() == [S + G - 1, S + G - 1]
        assert eng.kv.valid_len().tolist() == [cap, cap]
    _same_tokens(*reqs)


def test_stop_token_and_timing(model):
    _, pcfg, params, loras = model
    eng = ServingEngine(pcfg, _port(params), lora=_port(loras[2]),
                        n_slots=1, kv_capacity=S + G)
    eng.warmup()
    full = eng.submit(_prompts(pcfg, 1, key=5)[0], max_new_tokens=G)
    _drain(eng)
    # prefill consumed S steps; the first token comes out of the S-th,
    # so G - 1 further steps are pure decode
    assert len(full.decode_times) == G - 1 and full.prefill_s > 0
    assert full.t_finish >= full.t_first_token >= full.t_admit \
        >= full.t_submit
    stop = int(full.tokens[2])
    r = eng.submit(_prompts(pcfg, 1, key=5)[0], max_new_tokens=G,
                   stop_tokens=(stop,))
    _drain(eng)
    assert r.tokens.tolist() == full.tokens[:3].tolist()   # stop kept


def test_run_drains_a_batch_of_prompts(model):
    """The closed-loop convenience: submit, step until the queue drains,
    return the submitted requests (per-prompt adapters)."""
    jeng, peng = _engines(model, adapters=model[3][:2])
    prompts = list(_prompts(model[0], 3, key=10))
    ads = ["a0", "a1", "a0"]
    jreqs = jeng.run(prompts, max_new_tokens=G, adapter=ads)
    preqs = peng.run(prompts, max_new_tokens=G, adapter=ads)
    assert [r.rid for r in preqs] == [0, 1, 2]
    _same_tokens(jreqs, preqs)


# ---------------------------------------------------------------------------
# scheduler (the JAX package's own cases)
# ---------------------------------------------------------------------------


def _req(rid, prio=0):
    return Request(rid=rid, prompt=np.array([1], np.int32),
                   max_new_tokens=1, priority=prio)


def test_scheduler_fifo_order_and_recycle():
    sched = SlotScheduler(2, policy="fifo")
    for i in range(4):
        sched.submit(_req(i))
    assert [r.rid for _, r in sched.admit()] == [0, 1]
    assert sched.admit() == []                    # pool full
    sched.release(0)
    assert [r.rid for _, r in sched.admit()] == [2]
    assert sched.n_queued == 1 and sched.n_active == 2


def test_scheduler_priority_policy():
    sched = SlotScheduler(1, policy="priority")
    for rid, prio in ((0, 5), (1, 1), (2, 5)):
        sched.submit(_req(rid, prio))
    assert sched.admit()[0][1].rid == 1           # lowest priority value
    sched.release(0)
    assert sched.admit()[0][1].rid == 0           # FIFO among ties


def test_scheduler_rejects_bad_args():
    with pytest.raises(ValueError):
        SlotScheduler(0)
    with pytest.raises(ValueError):
        SlotScheduler(2, policy="lifo")


# ---------------------------------------------------------------------------
# adapter registry
# ---------------------------------------------------------------------------


def test_registry_lru_eviction_and_pinning(model):
    trees = [_port(t) for t in model[3]]
    reg = AdapterRegistry(trees[0], capacity=2)
    reg.add("a", trees[0])
    reg.add("b", trees[1])
    reg.index("a")                               # b is now LRU
    reg.add("c", trees[2])
    assert reg.evictions == 1
    assert "b" not in reg and "a" in reg and "c" in reg
    reg.pin("a")
    reg.pin("c")
    with pytest.raises(RuntimeError):
        reg.add("d", trees[1])
    reg.unpin("c")
    reg.add("d", trees[1])                       # evicts c, not pinned a
    assert "a" in reg and "c" not in reg


def test_registry_roundtrip_and_validation(model):
    _, pcfg, _, loras = model
    tree = _port(loras[0])
    reg = AdapterRegistry(tree, capacity=2)
    reg.add("x", tree)
    for (_, got), (_, want) in zip(interop.tree_paths(reg.get("x")),
                                   interop.tree_paths(tree)):
        assert torch.equal(got, want)
    with pytest.raises(KeyError):
        reg.index("missing")
    with pytest.raises(ValueError):              # rank mismatch
        reg.add("bad", PT.init_lora(pcfg, torch.Generator().manual_seed(0),
                                    rank=8))
    empty = AdapterRegistry.for_model(pcfg, rank=4, capacity=3,
                                      device="cpu")
    assert len(empty) == 0 and empty.ids() == []


# ---------------------------------------------------------------------------
# KV cache manager, capacity contract, kernel seam
# ---------------------------------------------------------------------------


def test_kv_reset_slot_zeroes_one_lane(model):
    _, pcfg, params, loras = model
    eng = ServingEngine(pcfg, _port(params), lora=_port(loras[2]),
                        n_slots=2, kv_capacity=S + G)
    prompts = _prompts(pcfg, 2, key=6)
    eng.submit(prompts[0], max_new_tokens=G)
    eng.submit(prompts[1], max_new_tokens=2)
    _drain(eng)
    kv = eng.kv
    k = kv.cache["stacks"]["layers"]["mixer"]["k"]
    assert bool(k[:, 1].abs().sum() > 0)
    kv.reset_slot(1)
    assert kv.positions().tolist()[1] == 0 and kv.positions()[0] > 0
    assert bool((k[:, 1] == 0).all()) and bool(k[:, 0].abs().sum() > 0)


def test_kv_positions_are_ragged(model):
    _, pcfg, params, loras = model
    eng = ServingEngine(pcfg, _port(params), lora=_port(loras[2]),
                        n_slots=2, kv_capacity=S + G)
    eng.submit(_prompts(pcfg, 1, key=7)[0], max_new_tokens=G)
    for _ in range(3):
        eng.step()
    eng.submit(_prompts(pcfg, 1, key=8)[0], max_new_tokens=G)
    eng.step()
    assert eng.kv.positions().tolist() == [4, 1]  # independent cursors
    assert not eng.kv.fits(S + G + 1) and eng.kv.fits(S + G)


def test_kv_manager_matches_jax_cache_layout(model):
    jcfg, pcfg, _, _ = model
    from repro.serving import KVCacheManager as JaxKV
    jkv, pkv = JaxKV(jcfg, 3, 7), KVCacheManager(pcfg, 3, 7, device="cpu")
    assert [tuple(a.shape) for _, a in interop.tree_paths(pkv.cache)] \
        == [a.shape for a in jax.tree.leaves(jkv.cache)]


def test_check_capacity_contract():
    check_capacity(16, 8, 8, False)              # exact fit
    with pytest.raises(ValueError):
        check_capacity(15, 8, 8, False)
    check_capacity(15, 8, 8, True)               # ring opt-in


def test_generate_window_validation(model):
    _, pcfg, params, loras = model
    prompts = torch.from_numpy(_prompts(pcfg, 1, key=9))
    p, lo = _port(params), _port(loras[2])
    with pytest.raises(ValueError):
        list(generate(pcfg, p, lo, prompts, G, window=S + G - 1,
                      warmup=False))
    out = [t for t, _ in generate(pcfg, p, lo, prompts, G, window=S + G - 1,
                                  ring=True, warmup=False)]
    assert len(out) == G


def test_engine_submit_validation(model):
    _, pcfg, params, loras = model
    p, lo = _port(params), _port(loras[2])
    eng = ServingEngine(pcfg, p, lora=lo, n_slots=1, kv_capacity=8)
    with pytest.raises(ValueError):               # over capacity
        eng.submit(np.arange(6, dtype=np.int32), max_new_tokens=6)
    with pytest.raises(ValueError):               # no registry
        eng.submit(np.arange(2, dtype=np.int32), max_new_tokens=2,
                   adapter="x")
    reg = AdapterRegistry(lo, capacity=1)
    eng2 = ServingEngine(pcfg, p, adapters=reg, n_slots=1, kv_capacity=8)
    with pytest.raises(ValueError):               # registry needs adapter
        eng2.submit(np.arange(2, dtype=np.int32), max_new_tokens=2)
    with pytest.raises(ValueError):               # both modes at once
        ServingEngine(pcfg, p, lora=lo, adapters=reg)
    with pytest.raises(ValueError):
        ServingEngine(pcfg, p, overflow="drop")


def test_kv_cache_flash_decode_seam():
    rng = np.random.default_rng(np.random.SeedSequence((13, 0)))
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
               for s in ((2, 1, 4, 8), (2, 7, 2, 8), (2, 7, 2, 8)))
    valid = torch.tensor([3, 7], dtype=torch.int32)
    from repro_torch.models.layers import attend
    want = attend(q, k, v, causal=False, kv_valid_len=valid)
    assert torch.equal(flash_decode(q, k, v, kv_valid_len=valid), want)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", [
    ["--n-adapters", "2"], ["--merge-lora"],
    ["--n-adapters", "2", "--arch", "granite-moe-1b-a400m"],
    ["--n-adapters", "2", "--arch", "mamba2-2.7b"],
    ["--n-adapters", "2", "--arch", "jamba-v0.1-52b"]],
    ids=["multi-tenant", "merged", "granite-moe-1b-a400m", "mamba2-2.7b",
         "jamba-v0.1-52b"])
def test_serve_cli_runs_on_cpu(mode):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--batch", "2", "--requests", "3", "--prompt-len", "4", "--gen",
         "3", *mode], capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "requests=3" in out.stdout and "tok/s" in out.stdout
