"""The PyTorch port's Mamba-2 decoding (``mamba2.init_mamba_cache``,
``mamba2.mamba_decode`` and ``decode_step`` on ``mamba_only`` blocks)
against the JAX package, on reduced mamba2-2.7b (d 128, d_inner 256, 8
heads of 32, N 16, G 1), f32 unless said otherwise.

Parameters always cross from the JAX package through numpy.

* ``init_mamba_cache`` and ``init_cache``: the same leaves, shapes and
  dtypes (``ssm`` f32 whatever the model dtype; ``mamba_only`` keeps its
  cache unwrapped, with no ``"mixer"`` key).
* ``mamba_decode`` for one layer over 6 steps from a populated state,
  with no LoRA, a 2-D LoRA and a per-slot ``(B, d, r)`` LoRA: outputs,
  the conv window and the SSM state within rtol = atol = 1e-5 (the two
  projections' summation order); the state advances in place through a
  view of a stacked cache; with every kernel branch forced on, no kernel
  is called (the JAX package keeps Mamba decoding plain).
* ``decode_step`` teacher-forced over S + G steps: logits within
  rel = abs = 1e-4, the limit ``test_torch_mamba.py`` holds prefill to;
  with f32 params and a bf16 cache (the serve CLI's setting) within
  1e-2, ``test_torch_model.py``'s bf16 limit.
* The engine with two adapters and more requests than slots: greedy
  tokens exactly equal to the JAX engine's.
* Within the port: prefill's last-token logits against teacher-forced
  decoding at the same position, within 1e-4 (the chunked SSD against
  the recurrence; f32 summation order).
* The train->serve hand-off: a ``bench-tiny`` DevFT run's ``global``
  adapter (``registry_from_run(..., personalize=False)``) served by each
  package's engine from its own run gives the same tokens.
"""
import dataclasses

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
from repro.models import mamba2 as JMb
from repro.models import transformer as JT
from repro.serving import AdapterRegistry as JaxRegistry
from repro.serving import ServingEngine as JaxEngine
from repro.serving import registry_from_run as jax_registry_from_run
from repro_torch import interop
from repro_torch.configs import ReducedSpec, get_config, reduce_config
from repro_torch.experiments import get_preset, run_experiment
from repro_torch.kernels import dispatch, ops
from repro_torch.models import mamba2 as PMb
from repro_torch.models import transformer as PT
from repro_torch.serving import (AdapterRegistry, ServingEngine,
                                 registry_from_run)

torch.set_num_threads(1)

ARCH = "mamba2-2.7b"
STEP_TOL = 1e-5
LOGIT_TOL = 1e-4
BF16_TOL = 1e-2


def _cfgs(test_spec, dtype="float32"):
    jcfg = jax_reduce_config(jax_get_config(ARCH), test_spec)
    pcfg = reduce_config(get_config(ARCH),
                         ReducedSpec(**dataclasses.asdict(test_spec)))
    return (dataclasses.replace(jcfg, dtype=dtype, kernel_backend="reference"),
            dataclasses.replace(pcfg, dtype=dtype, kernel_backend="reference"))


def _rng(*key):
    return np.random.default_rng(np.random.SeedSequence(
        [sum(map(ord, str(k))) for k in key]))


def _lora(jcfg, rng, *, batch=None, rank=4):
    """A nonzero LoRA tree, 2-D per layer or per slot ``(L, B, din, r)``
    as the engine hands it to ``decode_step``."""
    tmpl = JT.init_lora(jcfg, jax.random.PRNGKey(1), rank=rank)

    def one(a):
        shape = a.shape if batch is None else (a.shape[0], batch) + a.shape[1:]
        return (0.05 * rng.standard_normal(shape)).astype(np.float32)
    return jax.tree.map(one, tmpl)


def _params(jcfg):
    return jax.tree.map(np.asarray, JT.init_params(
        jcfg, jax.random.PRNGKey(0), jnp.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_mamba_cache_matches_jax(dtype, test_spec):
    jcfg, pcfg = _cfgs(test_spec, dtype)
    jc = JMb.init_mamba_cache(jcfg, 3, jnp.dtype(dtype))
    pc = PMb.init_mamba_cache(pcfg, 3, getattr(torch, dtype), "cpu")
    assert sorted(pc) == sorted(jc) == ["conv", "ssm"]
    for k in jc:
        assert tuple(pc[k].shape) == jc[k].shape, k
        assert str(pc[k].dtype).removeprefix("torch.") == jc[k].dtype.name
        assert not pc[k].any()
    assert pc["ssm"].dtype == torch.float32
    stacked = PMb.init_mamba_cache(pcfg, 3, torch.float32, "cpu", lead=(5,))
    assert tuple(stacked["conv"].shape) == (5,) + jc["conv"].shape
    # the model's cache: mamba_only's leaves unwrapped, (L, B, ...)
    jtree = JT.init_cache(jcfg, 3, 8)
    ptree = PT.init_cache(pcfg, 3, 8, device="cpu")
    assert sorted(ptree["stacks"]["layers"]) == ["conv", "ssm"]
    for (path, got), want in zip(interop.tree_paths(ptree),
                                 jax.tree.leaves(jtree)):
        assert tuple(got.shape) == want.shape, path
        assert str(got.dtype).removeprefix("torch.") == want.dtype.name


@pytest.mark.parametrize("lora_mode", ["none", "2d", "per-slot"])
def test_mamba_decode_matches_jax(lora_mode, test_spec):
    jcfg, pcfg = _cfgs(test_spec)
    rng = _rng("mamba_decode", lora_mode)
    b, steps = 3, 6
    layer = jax.tree.map(lambda a: a[1], _params(jcfg)["blocks"]["layers"])
    mixer = layer["mixer"]
    lora = None
    if lora_mode != "none":
        full = _lora(jcfg, rng, batch=b if lora_mode == "per-slot" else None)
        lora = jax.tree.map(lambda a: a[1], full["layers"])
    cache = jax.tree.map(np.asarray, JMb.init_mamba_cache(jcfg, b,
                                                          jnp.float32))
    cache = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in cache.items()}
    jcache = jax.tree.map(jnp.asarray, cache)
    # the port's cache is layer 1 of a stacked (L, ...) cache: the step
    # must advance the stack through the view
    stacked = {k: torch.zeros((2,) + v.shape) for k, v in cache.items()}
    for k, v in cache.items():
        stacked[k][1] = torch.from_numpy(v)
    view = {k: v[1] for k, v in stacked.items()}
    jm, jl = jax.tree.map(jnp.asarray, mixer), (
        None if lora is None else jax.tree.map(jnp.asarray, lora))
    pm = interop.from_numpy_tree(mixer)
    pl = None if lora is None else interop.from_numpy_tree(lora)
    for _ in range(steps):
        u = rng.standard_normal((b, 1, jcfg.d_model)).astype(np.float32)
        want, jcache = JMb.mamba_decode(jm, jcfg, jnp.asarray(u), jcache,
                                        lora=jl)
        got, out_cache = PMb.mamba_decode(pm, pcfg, torch.from_numpy(u),
                                          view, lora=pl)
        assert out_cache is view and got.shape == (b, 1, jcfg.d_model)
        _close(got, want, STEP_TOL)
    for k in ("conv", "ssm"):
        assert stacked[k][1].dtype == torch.float32
        _close(stacked[k][1], jcache[k], STEP_TOL)
        assert not stacked[k][0].any()           # the other layer untouched


def test_mamba_decode_never_reaches_a_kernel(test_spec, monkeypatch):
    """With the kernel branches taken as on the card (every backend but
    ``reference``) and the config asking for ``auto``, ``mamba_decode``
    runs the same plain math: a shared 2-D adapter does not reach
    ``lora_matmul``."""
    jcfg, pcfg = _cfgs(test_spec)
    rng = _rng("no_kernel")
    pcfg_k = dataclasses.replace(pcfg, kernel_backend="auto")
    layer = jax.tree.map(lambda a: a[0], _params(jcfg)["blocks"]["layers"])
    lora = jax.tree.map(lambda a: a[0], _lora(jcfg, rng)["layers"])
    pm, pl = interop.from_numpy_tree(layer["mixer"]), \
        interop.from_numpy_tree(lora)
    u = torch.from_numpy(rng.standard_normal(
        (2, 1, jcfg.d_model)).astype(np.float32))
    fresh = lambda: PMb.init_mamba_cache(  # noqa: E731
        pcfg, 2, torch.float32, "cpu")
    plain, plain_c = PMb.mamba_decode(pm, pcfg, u, fresh(), lora=pl)
    called = []

    def spy(name):
        def fn(*a, **kw):
            called.append(name)
            raise AssertionError(f"{name} reached from mamba_decode")
        return fn
    monkeypatch.setattr(dispatch, "use_kernel",
                        lambda backend, device: backend != "reference")
    for name in ("lora_matmul", "ssd_scan", "flash_attention",
                 "moe_expert_ffn"):
        monkeypatch.setattr(ops, name, spy(name))
    forced, forced_c = PMb.mamba_decode(pm, pcfg_k, u, fresh(), lora=pl)
    assert called == []
    assert torch.equal(forced, plain)
    for k in ("conv", "ssm"):
        assert torch.equal(forced_c[k], plain_c[k])


def _teacher_forced(jcfg, pcfg, params, lora, tokens, cache_dtype):
    """Logits of every decode step over ``tokens`` (B, T), both packages."""
    b, t = tokens.shape
    jc = JT.init_cache(jcfg, b, t, jnp.dtype(cache_dtype))
    pc = PT.init_cache(pcfg, b, t, getattr(torch, cache_dtype), "cpu")
    step = jax.jit(lambda p, l, tok, c: JT.decode_step(jcfg, p, l, tok, c))
    jp, jl = jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray,
                                                             lora)
    pp, pl = interop.from_numpy_tree(params), interop.from_numpy_tree(lora)
    out = []
    for i in range(t):
        tok = tokens[:, i:i + 1]
        jlog, jc = step(jp, jl, jnp.asarray(tok), jc)
        plog, pc = PT.decode_step(pcfg, pp, pl, torch.from_numpy(tok), pc)
        out.append((plog, jlog))
    return out, pc, jc


@pytest.mark.parametrize("cache_dtype,tol", [("float32", LOGIT_TOL),
                                             ("bfloat16", BF16_TOL)],
                         ids=["f32", "f32-params-bf16-cache"])
def test_decode_step_teacher_forced_matches_jax(cache_dtype, tol,
                                                test_spec):
    jcfg, pcfg = _cfgs(test_spec, cache_dtype)
    rng = _rng("teacher", cache_dtype)
    s, g = 8, 6
    params, lora = _params(jcfg), _lora(jcfg, rng)
    tokens = rng.integers(0, jcfg.vocab, (2, s + g)).astype(np.int32)
    steps, pc, jc = _teacher_forced(jcfg, pcfg, params, lora, tokens,
                                    cache_dtype)
    for plog, jlog in steps:
        assert tuple(plog.shape) == jlog.shape == (2, 1, jcfg.padded_vocab)
        live = slice(0, jcfg.vocab)
        _close(plog[..., live], np.asarray(jlog)[..., live], tol)
    np.testing.assert_array_equal(pc["pos"].numpy(), np.asarray(jc["pos"]))
    for (path, got), want in zip(interop.tree_paths(pc["stacks"]),
                                 jax.tree.leaves(jc["stacks"])):
        assert str(got.dtype).removeprefix("torch.") == want.dtype.name
        _close(got, want, tol)


def test_decode_at_zero_heads_uses_zero_rotary_tables(test_spec):
    """Full mamba2-2.7b has no attention heads (``hd`` falls back to
    d_model); ``decode_step`` must not build d_model-wide rotary tables.
    The reduced config with ``n_heads = 0`` decodes like the reduced one
    (the rotary tables reach no Mamba block)."""
    _, pcfg = _cfgs(test_spec)
    nohead = dataclasses.replace(pcfg, n_heads=0, n_kv_heads=0)
    gen = torch.Generator().manual_seed(0)
    params = PT.init_params(pcfg, gen)
    tok = torch.tensor([[3], [5]])
    a, _ = PT.decode_step(pcfg, params, None, tok,
                          PT.init_cache(pcfg, 2, 4, device="cpu"))
    b, _ = PT.decode_step(nohead, params, None, tok,
                          PT.init_cache(nohead, 2, 4, device="cpu"))
    assert torch.equal(a, b)
    assert get_config(ARCH).n_heads == 0 and get_config(ARCH).hd == 2560


def _serve_both(jcfg, pcfg, params, adapters, prompts, gen, n_slots):
    jp, pp = jax.tree.map(jnp.asarray, params), interop.from_numpy_tree(params)
    out = []
    for cfg, p, conv, Engine, Registry in (
            (jcfg, jp, lambda t: jax.tree.map(jnp.asarray, t), JaxEngine,
             JaxRegistry),
            (pcfg, pp, interop.from_numpy_tree, ServingEngine,
             AdapterRegistry)):
        reg = Registry(conv(adapters[0]), capacity=len(adapters))
        for i, a in enumerate(adapters):
            reg.add(f"a{i}", conv(a))
        eng = Engine(cfg, p, adapters=reg, n_slots=n_slots,
                     kv_capacity=max(len(pr) for pr in prompts) + gen)
        reqs = [eng.submit(pr, max_new_tokens=gen, adapter=f"a{i % 2}")
                for i, pr in enumerate(prompts)]
        while eng.has_work():
            eng.step()
        out.append(reqs)
    return out


def test_engine_tokens_equal_jax_with_recycling(test_spec):
    jcfg, pcfg = _cfgs(test_spec)
    rng = _rng("engine")
    params = _params(jcfg)
    adapters = [_lora(jcfg, rng) for _ in range(2)]
    prompts = [rng.integers(0, jcfg.vocab, n).astype(np.int32)
               for n in (5, 3, 7, 4, 6)]
    jreqs, preqs = _serve_both(jcfg, pcfg, params, adapters, prompts, 5, 2)
    for jr, pr in zip(jreqs, preqs):
        assert pr.done and len(pr.tokens) == 5
        np.testing.assert_array_equal(pr.tokens, jr.tokens)


def test_prefill_matches_teacher_forced_decode(test_spec):
    """Within the port: the chunked SSD forward's last-token logits equal
    the recurrence's at the same position, within 1e-4."""
    _, pcfg = _cfgs(test_spec)
    rng = _rng("prefill_vs_decode")
    gen = torch.Generator().manual_seed(0)
    params = PT.init_params(pcfg, gen)
    lora = PT.init_lora(pcfg, gen, rank=4)
    for stack in lora.values():
        for ab in stack.values():
            ab["b"].normal_(0.0, 0.05, generator=gen)
    for s in (40, 13):                       # ragged, shorter than a chunk
        tokens = torch.from_numpy(
            rng.integers(0, pcfg.vocab, (2, s)).astype(np.int64))
        want = PT.prefill(pcfg, params, lora, {"tokens": tokens})
        cache = PT.init_cache(pcfg, 2, s, device="cpu")
        for i in range(s):
            got, cache = PT.decode_step(pcfg, params, lora, tokens[:, i:i + 1],
                                        cache)
        live = slice(0, pcfg.vocab)
        torch.testing.assert_close(got[..., live], want[..., live],
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)


@pytest.fixture(scope="module")
def handoff():
    """A bench-tiny DevFT run of reduced mamba2-2.7b in both packages,
    from the JAX package's pretrained base and initial LoRA: (port
    result, JAX result, port params, JAX params)."""
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
    assert set(preg.get("global")["layers"]) == {"in_proj", "out_proj"}
    rng = _rng("handoff")
    prompts = [rng.integers(0, got.spec.build_cfg().vocab, n).astype(np.int32)
               for n in (6, 4, 5)]
    toks = []
    for cfg, params, reg, Engine in (
            (got.spec.build_cfg(), pparams, preg, ServingEngine),
            (want.spec.build_cfg(), jparams, jreg, JaxEngine)):
        eng = Engine(cfg, params, adapters=reg, n_slots=2, kv_capacity=12)
        reqs = [eng.submit(p, max_new_tokens=6, adapter="global")
                for p in prompts]
        while eng.has_work():
            eng.step()
        toks.append([list(r.generated) for r in reqs])
    assert all(len(t) == 6 for t in toks[0])
    assert toks[0] == toks[1]
