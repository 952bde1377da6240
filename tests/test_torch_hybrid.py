"""The PyTorch port's hybrid order (jamba-v0.1: ``mamba_mlp``,
``mamba_moe`` and ``attn_mlp`` stacks interleaved) against the JAX
package.

* ``hybrid_order`` and ``execution_order``: exactly equal over a grid of
  stack sizes, the full model's (28 / 16 / 4 -> 3 / 4 / 1 per period),
  DevFT-like submodel sizes and empty stacks, and for the homogeneous
  families.
* On reduced jamba (one interleave period of 8 layers: stacks 3 / 4 /
  1; d 128, 4 heads of 32 over 2, 4 experts top 2, N 16), f32, with
  parameters crossed from the JAX package through numpy:
  - the params, LoRA and decode-cache trees: the same key paths, leaf
    order, shapes and dtypes;
  - prefill's last-token logits, and the loss and every LoRA gradient
    of ``loss_fn`` against ``jax.value_and_grad``, at rel = abs = 1e-4
    (summation order; the limit ``test_torch_mamba.py`` and
    ``test_torch_moe.py`` use);
  - ``decode_step`` teacher-forced over S + G steps with a per-slot
    LoRA: logits and the whole cache within 1e-4;
  - the engine with two adapters and more requests than slots: greedy
    tokens exactly equal to the JAX engine's;
  - submodels with one stack empty (as DevFT's stages may cut them):
    prefill, loss and LoRA gradients within 1e-4, the empty stack's
    gradients zeros as JAX gives them.
"""
import dataclasses

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
from repro_torch.configs import ReducedSpec, get_config, reduce_config
from repro_torch.models import transformer as PT
from repro_torch.serving import AdapterRegistry, ServingEngine

torch.set_num_threads(1)

ARCH = "jamba-v0.1-52b"
TOL = 1e-4


def _cfgs(test_spec, dtype="float32"):
    jcfg = jax_reduce_config(jax_get_config(ARCH), test_spec)
    pcfg = reduce_config(get_config(ARCH),
                         ReducedSpec(**dataclasses.asdict(test_spec)))
    return (dataclasses.replace(jcfg, dtype=dtype, kernel_backend="reference"),
            dataclasses.replace(pcfg, dtype=dtype, kernel_backend="reference"))


def _rng(*key):
    return np.random.default_rng(np.random.SeedSequence(
        [sum(map(ord, str(k))) for k in key]))


SIZES = [(28, 16, 4), (3, 4, 1), (0, 0, 0), (1, 0, 0), (0, 1, 0),
         (0, 0, 1), (0, 0, 3), (2, 2, 0), (1, 1, 1), (2, 1, 1), (5, 2, 1),
         (1, 2, 1), (3, 4, 2), (7, 8, 2), (14, 8, 2), (6, 6, 3), (2, 5, 1),
         (10, 3, 7)]


@pytest.mark.parametrize("mm,mo,at", SIZES)
def test_hybrid_order_is_exactly_equal(mm, mo, at):
    sizes = {"mamba_mlp": mm, "mamba_moe": mo, "attn_mlp": at}
    want = JT.hybrid_order(sizes)
    got = PT.hybrid_order(sizes)
    assert got == [tuple(x) for x in want]
    assert len(got) == mm + mo + at
    for name, n in sizes.items():
        assert [i for s, i in got if s == name] == list(range(n))
    # missing stacks count as empty
    sparse = {k: v for k, v in sizes.items() if v}
    assert PT.hybrid_order(sparse) == got


def test_full_jamba_order_is_one_attention_layer_in_eight():
    cfg = get_config(ARCH)
    order = PT.execution_order(cfg)
    assert order == [tuple(x) for x in JT.execution_order(
        jax_get_config(ARCH))]
    names = [s for s, _ in order]
    assert len(names) == 32
    assert [i for i, s in enumerate(names) if s == "attn_mlp"] \
        == [4, 12, 20, 28]
    assert [i for i, s in enumerate(names) if s == "mamba_moe"] \
        == list(range(1, 32, 2))


@pytest.mark.parametrize("arch", ["qwen2-7b", "granite-moe-1b-a400m",
                                  "mamba2-2.7b", ARCH])
@pytest.mark.parametrize("sizes", [None, "half"])
def test_execution_order_is_exactly_equal(arch, sizes):
    pcfg, jcfg = get_config(arch), jax_get_config(arch)
    if sizes == "half":
        sizes = {name: n // 2 for name, n in pcfg.layer_stacks()}
    assert PT.execution_order(pcfg, sizes) == [
        tuple(x) for x in JT.execution_order(jcfg, sizes)]


def _structure(tree):
    return [(tuple(p), tuple(a.shape), str(a.dtype).removeprefix("torch."))
            for p, a in interop.tree_paths(tree)]


def _jax_structure(tree):
    return [(tuple(getattr(k, "key", k) for k in path), tuple(a.shape),
             a.dtype.name)
            for path, a in jax.tree_util.tree_flatten_with_path(tree)[0]]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_trees_mirror_jax(dtype, test_spec):
    jcfg, pcfg = _cfgs(test_spec, dtype)
    gen = torch.Generator().manual_seed(0)
    pparams = PT.init_params(pcfg, gen)
    assert PT.stack_sizes(pparams["blocks"]) == {
        "mamba_mlp": 3, "mamba_moe": 4, "attn_mlp": 1}
    for jtree, ptree in (
            (JT.init_params(jcfg, jax.random.PRNGKey(0)), pparams),
            (JT.init_lora(jcfg, jax.random.PRNGKey(0), rank=4),
             PT.init_lora(pcfg, gen, rank=4)),
            (JT.init_cache(jcfg, 3, 8), PT.init_cache(pcfg, 3, 8,
                                                      device="cpu"))):
        assert _structure(ptree) == _jax_structure(jtree)
    lora = PT.init_lora(pcfg, gen, rank=4)
    assert {s: sorted(t) for s, t in lora.items()} == {
        "mamba_mlp": ["in_proj", "out_proj"],
        "mamba_moe": ["in_proj", "out_proj"], "attn_mlp": ["wq", "wv"]}


def _setup(jcfg, rng, batch=2, seq=24):
    params = jax.tree.map(np.asarray, JT.init_params(
        jcfg, jax.random.PRNGKey(0), jnp.float32))
    lora = jax.tree.map(
        lambda a: (0.05 * rng.standard_normal(a.shape)).astype(np.float32),
        JT.init_lora(jcfg, jax.random.PRNGKey(1), rank=4))
    tokens = rng.integers(0, jcfg.vocab, (batch, seq)).astype(np.int32)
    labels = rng.integers(0, jcfg.vocab, (batch, seq)).astype(np.int32)
    labels[1, 3] = -1
    return params, lora, {"tokens": tokens, "labels": labels}


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def test_prefill_logits_match_jax(test_spec):
    jcfg, pcfg = _cfgs(test_spec)
    params, lora, batch = _setup(jcfg, _rng("prefill"), seq=40)
    want = jax.jit(lambda p, lo, bt: JT.prefill(jcfg, p, lo, bt))(
        *(jax.tree.map(jnp.asarray, t) for t in (params, lora, batch)))
    got = PT.prefill(pcfg, interop.from_numpy_tree(params),
                     interop.from_numpy_tree(lora), batch)
    assert tuple(got.shape) == want.shape == (2, 1, pcfg.padded_vocab)
    _close(got, want)


def test_loss_and_lora_grads_match_jax(test_spec):
    jcfg, pcfg = _cfgs(test_spec)
    params, lora, batch = _setup(jcfg, _rng("grads"))
    (jt, jm), jg = jax.jit(jax.value_and_grad(
        lambda lo, p, bt: JT.loss_fn(jcfg, p, lo, bt), has_aux=True))(
        *(jax.tree.map(jnp.asarray, t) for t in (lora, params, batch)))
    pt, pm, pg = PT.loss_and_lora_grads(pcfg,
                                        interop.from_numpy_tree(params),
                                        interop.from_numpy_tree(lora), batch)
    assert float(jm["aux"]) > 0                 # four MoE layers' router loss
    for g, w in [(pt, jt)] + [(pm[k], jm[k]) for k in ("loss", "aux", "acc")]:
        np.testing.assert_allclose(float(g), float(w), rtol=TOL, atol=TOL)
    paths = interop.tree_paths(pg)
    assert [p for p, _ in paths] == [
        tuple(k.key for k in path)
        for path, _ in jax.tree_util.tree_flatten_with_path(jg)[0]]
    for (path, g), w in zip(paths, jax.tree.leaves(jg)):
        assert float(np.abs(np.asarray(w)).max()) > 0, path
        _close(g, w)


def test_decode_step_teacher_forced_matches_jax(test_spec):
    jcfg, pcfg = _cfgs(test_spec)
    rng = _rng("decode")
    b, s, g = 3, 6, 5
    params, _, _ = _setup(jcfg, rng)
    # per-slot adapters, layer-major (L, B, din, r) as the engine makes them
    lora = jax.tree.map(
        lambda a: (0.05 * rng.standard_normal(
            (a.shape[0], b) + a.shape[1:])).astype(np.float32),
        JT.init_lora(jcfg, jax.random.PRNGKey(1), rank=4))
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
        _close(plog[..., :jcfg.vocab], np.asarray(jlog)[..., :jcfg.vocab])
    np.testing.assert_array_equal(pc["pos"].numpy(), np.asarray(jc["pos"]))
    assert _structure(pc) == _jax_structure(jc)
    for (path, got), want in zip(interop.tree_paths(pc["stacks"]),
                                 jax.tree.leaves(jc["stacks"])):
        assert got.any(), path                # every layer's state moved
        _close(got, want)


def test_engine_tokens_equal_jax_with_recycling(test_spec):
    jcfg, pcfg = _cfgs(test_spec)
    rng = _rng("engine")
    params, _, _ = _setup(jcfg, rng)
    adapters = [jax.tree.map(
        lambda a: (0.05 * rng.standard_normal(a.shape)).astype(np.float32),
        JT.init_lora(jcfg, jax.random.PRNGKey(i), rank=4)) for i in range(2)]
    prompts = [rng.integers(0, jcfg.vocab, n).astype(np.int32)
               for n in (5, 3, 6, 4)]
    gen = 4
    toks = []
    for cfg, conv, Engine, Registry in (
            (jcfg, lambda t: jax.tree.map(jnp.asarray, t), JaxEngine,
             JaxRegistry),
            (pcfg, interop.from_numpy_tree, ServingEngine, AdapterRegistry)):
        reg = Registry(conv(adapters[0]), capacity=2)
        for i, a in enumerate(adapters):
            reg.add(f"a{i}", conv(a))
        eng = Engine(cfg, conv(params), adapters=reg, n_slots=2,
                     kv_capacity=10)
        reqs = [eng.submit(p, max_new_tokens=gen, adapter=f"a{i % 2}")
                for i, p in enumerate(prompts)]
        while eng.has_work():
            eng.step()
        toks.append([r.tokens for r in reqs])
    for jt, pt in zip(*toks):
        assert len(pt) == gen
        np.testing.assert_array_equal(pt, jt)


@pytest.mark.parametrize("sizes", [(1, 2, 0), (2, 0, 1), (0, 3, 1)],
                         ids=lambda s: "-".join(map(str, s)))
def test_submodel_with_an_empty_stack_matches_jax(sizes, test_spec):
    """A submodel of the hybrid order (the stacks cut to ``sizes``, one
    of them empty, as DevFT's stages may cut them): prefill logits, the
    loss and every LoRA gradient against JAX, the empty stack's zeros
    included."""
    jcfg, pcfg = _cfgs(test_spec)
    params, lora, batch = _setup(jcfg, _rng("submodel", sizes), seq=16)
    cut = dict(zip(("mamba_mlp", "mamba_moe", "attn_mlp"), sizes))
    params["blocks"] = {name: jax.tree.map(lambda a, n=cut[name]: a[:n],
                                           stack)
                        for name, stack in params["blocks"].items()}
    lora = {name: jax.tree.map(lambda a, n=cut[name]: a[:n], stack)
            for name, stack in lora.items()}
    jp, jl, jb = (jax.tree.map(jnp.asarray, t) for t in (params, lora, batch))
    pp, pl = interop.from_numpy_tree(params), interop.from_numpy_tree(lora)
    assert PT.execution_order(pcfg, PT.stack_sizes(pp["blocks"])) == [
        tuple(x) for x in JT.execution_order(
            jcfg, JT.stack_sizes(jp["blocks"]))]
    _close(PT.prefill(pcfg, pp, pl, batch), jax.jit(
        lambda p, lo, bt: JT.prefill(jcfg, p, lo, bt))(jp, jl, jb))
    (jt, _), jg = jax.jit(jax.value_and_grad(
        lambda lo, p, bt: JT.loss_fn(jcfg, p, lo, bt), has_aux=True))(
        jl, jp, jb)
    pt, _, pg = PT.loss_and_lora_grads(pcfg, pp, pl, batch)
    np.testing.assert_allclose(float(pt), float(jt), rtol=TOL, atol=TOL)
    for (path, g), w in zip(interop.tree_paths(pg), jax.tree.leaves(jg)):
        assert tuple(g.shape) == w.shape, path
        _close(g, w)


def test_lora_leaf_the_loss_does_not_reach_raises(test_spec):
    """Only an empty stack's leaves get zero gradients: a non-empty leaf
    that the loss never reaches (here a stack no layer reads) raises."""
    _, pcfg = _cfgs(test_spec)
    gen = torch.Generator().manual_seed(0)
    params = PT.init_params(pcfg, gen)
    lora = PT.init_lora(pcfg, gen, rank=4)
    lora["unread"] = interop.tree_map(torch.clone, lora["attn_mlp"])
    rng = _rng("unreached")
    tokens = rng.integers(0, pcfg.vocab, (2, 8)).astype(np.int32)
    batch = {"tokens": tokens, "labels": tokens}
    with pytest.raises(RuntimeError, match="unread"):
        PT.loss_and_lora_grads(pcfg, params, lora, batch)
