"""The PyTorch port's MLA (deepseek-v3's multi-head latent attention)
against the JAX package.

On reduced deepseek-v3 (``reduce_config``: 1 dense ``mla_mlp`` layer and
2 ``mla_moe`` layers with the shared expert; d 128, 4 heads, MLA ranks
q 64 / kv 32, rope 16, nope 32, v 32; 4 experts top 2), f32, with
parameters crossed from the JAX package through numpy:

* the params, LoRA and decode-cache trees: the same key paths, leaf
  order, shapes and dtypes; the LoRA targets ``wq_b`` and ``wkv_b``;
  rotary tables over ``qk_rope_head_dim`` (deepseek's ``hd`` is 56, its
  rope 64);
* ``_mla_q``, ``_mla_ckv`` and ``mla_attention`` of one layer, prefill's
  logits, and ``loss_fn`` at 1e-5; every LoRA gradient at 1e-4;
* ``mla_decode`` (the absorbed formulation: one ``flash_decode`` call at
  hd = 32 + 16, vd = 32, one kv head) with no LoRA, a 2-D LoRA and
  per-slot LoRA, step by step through a view of a stacked cache, at
  1e-5; the other layer's cache untouched;
* the ``flash_decode`` branch taken as on the card (the backend the
  config names) against JAX's Pallas kernel in interpret mode;
* ``decode_step`` teacher-forced with per-slot adapters, logits and the
  whole cache; prefill's last-token logits against decoding's;
* the engine with two adapters and more requests than slots: greedy
  tokens exactly equal to the JAX engine's;
* a DevFT-like submodel (the dense and MoE stacks cut to one layer
  each): prefill, loss and LoRA gradients;
* the dense prefix running before the MoE stack; ``moe_block`` with the
  shared expert at deepseek-v3's own widths (d 7168, ff 2048; the routed
  experts cut to 2); the KV manager's reset of a slot's latent lanes.
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
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.serving import AdapterRegistry as JaxRegistry
from repro.serving import ServingEngine as JaxEngine
from repro_torch import interop
from repro_torch.configs import ReducedSpec, get_config, reduce_config
from repro_torch.models import layers as PL
from repro_torch.models import transformer as PT
from repro_torch.serving import AdapterRegistry, ServingEngine

torch.set_num_threads(1)

ARCH = "deepseek-v3-671b"
TOL = 1e-5
GRAD_TOL = 1e-4


def _cfgs(test_spec, dtype="float32", backend="reference"):
    jcfg = jax_reduce_config(jax_get_config(ARCH), test_spec)
    pcfg = reduce_config(get_config(ARCH),
                         ReducedSpec(**dataclasses.asdict(test_spec)))
    return (dataclasses.replace(jcfg, dtype=dtype, kernel_backend=backend),
            dataclasses.replace(pcfg, dtype=dtype, kernel_backend=backend))


def _rng(*key):
    return np.random.default_rng(np.random.SeedSequence(
        [sum(map(ord, str(k))) for k in key]))


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


def _structure(tree):
    return [(tuple(p), tuple(a.shape), str(a.dtype).removeprefix("torch."))
            for p, a in interop.tree_paths(tree)]


def _jax_structure(tree):
    return [(tuple(getattr(k, "key", k) for k in path), tuple(a.shape),
             a.dtype.name)
            for path, a in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _layer(tree, i):
    return jax.tree.map(lambda a: a[i], tree)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_trees_mirror_jax(dtype, test_spec):
    jcfg, pcfg = _cfgs(test_spec, dtype)
    gen = torch.Generator().manual_seed(0)
    pparams = PT.init_params(pcfg, gen)
    assert PT.stack_kinds(pcfg) == {"dense": "mla_mlp", "moe": "mla_moe"}
    assert PT.stack_sizes(pparams["blocks"]) == {"dense": 1, "moe": 2}
    for jtree, ptree in (
            (JT.init_params(jcfg, jax.random.PRNGKey(0)), pparams),
            (JT.init_lora(jcfg, jax.random.PRNGKey(0), rank=4),
             PT.init_lora(pcfg, gen, rank=4)),
            (JT.init_cache(jcfg, 3, 8), PT.init_cache(pcfg, 3, 8,
                                                      device="cpu"))):
        assert _structure(ptree) == _jax_structure(jtree)
    for kind in ("mla_mlp", "mla_moe"):
        assert PT._block_lora_targets(pcfg, kind) \
            == JT._block_lora_targets(jcfg, kind)
    assert "shared" in pparams["blocks"]["moe"]["ffn"]


def test_rotary_tables_take_the_rope_head_dim(test_spec):
    """MLA rotates only its rope part: deepseek's ``hd`` (d / heads = 56)
    is not the rotary dim (64)."""
    full = get_config(ARCH)
    assert (full.hd, PT.rope_dim(full)) == (56, 64)
    _, pcfg = _cfgs(test_spec)
    x, cos, sin, n_prefix = PT._embed_inputs(pcfg, {"embed": torch.zeros(
        pcfg.padded_vocab, pcfg.d_model)}, {"tokens": np.zeros((2, 5),
                                                               np.int32)})
    assert tuple(cos.shape) == tuple(sin.shape) == (
        2, 5, pcfg.mla.qk_rope_head_dim // 2)
    assert n_prefix == 0
    assert PT.rope_dim(get_config("mamba2-2.7b")) == 0
    assert PT.rope_dim(get_config("qwen2-7b")) == get_config("qwen2-7b").hd


def _one_layer(jcfg, rng, seq=12):
    params, lora, _ = _setup(jcfg, rng)
    p = _layer(params["blocks"]["moe"]["mixer"], 1)
    lo = _layer(lora["moe"], 1)
    x = rng.standard_normal((2, seq, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(seq, dtype=np.int32), (2, seq))
    cos, sin = JL.rope_cos_sin(jnp.asarray(pos), jcfg.mla.qk_rope_head_dim,
                               jcfg.rope_theta)
    return p, lo, x, np.array(cos), np.array(sin)


@pytest.mark.parametrize("with_lora", [False, True])
def test_mla_projections_and_attention_match_jax(with_lora, test_spec):
    jcfg, pcfg = _cfgs(test_spec)
    p, lo, x, cos, sin = _one_layer(jcfg, _rng("layer", with_lora))
    lo = lo if with_lora else None
    tp, tlo = interop.from_numpy_tree(p), (
        interop.from_numpy_tree(lo) if lo else None)
    tx, tcos, tsin = (torch.from_numpy(a) for a in (x, cos, sin))
    jq = JL._mla_q(p, jcfg, x, cos, sin, lo)
    pq = PL._mla_q(tp, pcfg, tx, tcos, tsin, tlo)
    jc = JL._mla_ckv(p, jcfg, x, cos, sin)
    pc = PL._mla_ckv(tp, pcfg, tx, tcos, tsin)
    for got, want in zip((*pq, *pc), (*jq, *jc)):
        assert tuple(got.shape) == want.shape
        _close(got, want)
    _close(PL.mla_attention(tp, pcfg, tx, tcos, tsin, lora=tlo),
           JL.mla_attention(p, jcfg, x, cos, sin, lora=lo))


def test_mla_attention_gradients_match_jax(test_spec):
    """The gradients of a fixed projection of one layer's output with
    respect to its input and its ``wq_b``/``wkv_b`` adapters."""
    jcfg, pcfg = _cfgs(test_spec)
    rng = _rng("attn-grads")
    p, lo, x, cos, sin = _one_layer(jcfg, rng)
    proj = rng.standard_normal((2, x.shape[1], jcfg.d_model)).astype(
        np.float32)

    def jloss(xx, ll):
        return jnp.sum(JL.mla_attention(p, jcfg, xx, cos, sin, lora=ll)
                       * proj)
    jgx, jgl = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x),
                                               jax.tree.map(jnp.asarray, lo))
    tx = torch.from_numpy(x).requires_grad_(True)
    tl = interop.tree_map(lambda t: t.requires_grad_(True),
                          interop.from_numpy_tree(lo))
    out = PL.mla_attention(interop.from_numpy_tree(p), pcfg, tx,
                           torch.from_numpy(cos), torch.from_numpy(sin),
                           lora=tl)
    (out * torch.from_numpy(proj)).sum().backward()
    _close(tx.grad, jgx, GRAD_TOL)
    for (path, t), w in zip(interop.tree_paths(tl), jax.tree.leaves(jgl)):
        assert float(np.abs(np.asarray(w)).max()) > 0, path
        _close(t.grad, w, GRAD_TOL)


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
    assert float(jm["aux"]) > 0                 # two MoE layers' router loss
    for g, w in [(pt, jt)] + [(pm[k], jm[k]) for k in ("loss", "aux", "acc")]:
        np.testing.assert_allclose(float(g), float(w), rtol=TOL, atol=TOL)
    paths = interop.tree_paths(pg)
    assert [p for p, _ in paths] == [
        tuple(k.key for k in path)
        for path, _ in jax.tree_util.tree_flatten_with_path(jg)[0]]
    assert {p[1] for p, _ in paths} == {"wq_b", "wkv_b"}
    for (path, g), w in zip(paths, jax.tree.leaves(jg)):
        assert float(np.abs(np.asarray(w)).max()) > 0, path
        _close(g, w, GRAD_TOL)


def _decode_lora(jcfg, rng, mode, b):
    """One layer's adapters: none, 2-D, or per slot (B, din, r)."""
    if mode == "none":
        return None
    lo = _layer(JT.init_lora(jcfg, jax.random.PRNGKey(1), rank=4)["moe"], 1)
    lead = (b,) if mode == "per-slot" else ()
    return jax.tree.map(lambda a: (0.05 * rng.standard_normal(
        lead + a.shape)).astype(np.float32), lo)


@pytest.mark.parametrize("mode", ["none", "2d", "per-slot"])
def test_mla_decode_through_a_stacked_cache_view_matches_jax(mode,
                                                             test_spec):
    """Steps of one layer's absorbed decode, the port writing layer 1 of
    a two-layer stacked cache through its view, against JAX's returned
    caches; layer 0's cache stays zero."""
    jcfg, pcfg = _cfgs(test_spec)
    rng = _rng("mla-decode", mode)
    b, steps, cap = 3, 7, 5                       # wraps the ring buffer
    params, _, _ = _setup(jcfg, rng)
    p = _layer(params["blocks"]["moe"]["mixer"], 1)
    lo = _decode_lora(jcfg, rng, mode, b)
    tp = interop.from_numpy_tree(p)
    tlo = None if lo is None else interop.from_numpy_tree(lo)
    stacked = PL.init_mla_cache(pcfg, b, cap, torch.float32, "cpu",
                                lead=(2,))
    view = interop.tree_map(lambda a: a[1], stacked)
    jc = JL.init_mla_cache(jcfg, b, cap, jnp.float32)
    pos = np.array([0, 2, 4], np.int32)
    rope = jcfg.mla.qk_rope_head_dim
    for _ in range(steps):
        x = rng.standard_normal((b, 1, jcfg.d_model)).astype(np.float32)
        cos, sin = JL.rope_cos_sin(jnp.asarray(pos[:, None]), rope,
                                   jcfg.rope_theta)
        jy, jc = JL.mla_decode(p, jcfg, jnp.asarray(x), jc, jnp.asarray(pos),
                               cos, sin, lora=lo)
        py, view = PL.mla_decode(tp, pcfg, torch.from_numpy(x), view,
                                 torch.from_numpy(pos),
                                 torch.from_numpy(np.asarray(cos)),
                                 torch.from_numpy(np.asarray(sin)), lora=tlo)
        _close(py, jy)
        pos = pos + 1
    for key in ("c", "k_rope"):
        _close(stacked[key][1], jc[key])
        assert not stacked[key][0].any()
        assert stacked[key][1].data_ptr() == view[key].data_ptr()


def test_flash_decode_branch_matches_jax_pallas(test_spec, monkeypatch):
    """The absorbed decode's attention as the card takes it (the config's
    backend names the kernel): one ``flash_decode`` call at the q^v shape
    (hd = kv rank + rope, vd = kv rank, one kv head), against JAX's
    ``mla_decode`` through its Pallas kernel in interpret mode."""
    jcfg, pcfg = _cfgs(test_spec, backend="pallas")
    rng = _rng("pallas")
    b, cap = 3, 9
    params, _, _ = _setup(jcfg, rng)
    p = _layer(params["blocks"]["moe"]["mixer"], 1)
    lo = _decode_lora(jcfg, rng, "2d", b)
    m = jcfg.mla
    calls = []
    real = PL.dispatch.get_kernel

    def spy(name, backend, device):
        fn = real(name, backend, device)

        def kernel(q, k, v, **kw):
            calls.append((name, backend, tuple(q.shape), tuple(k.shape),
                          tuple(v.shape)))
            return fn(q, k, v, **kw)
        return kernel
    monkeypatch.setattr(PL, "dispatch", types.SimpleNamespace(
        get_kernel=spy, use_kernel=PL.dispatch.use_kernel))
    jc = JL.init_mla_cache(jcfg, b, cap, jnp.float32)
    pc = PL.init_mla_cache(pcfg, b, cap, torch.float32, "cpu")
    pos = np.array([0, 3, 8], np.int32)
    for _ in range(4):
        x = rng.standard_normal((b, 1, jcfg.d_model)).astype(np.float32)
        cos, sin = JL.rope_cos_sin(jnp.asarray(pos[:, None]),
                                   m.qk_rope_head_dim, jcfg.rope_theta)
        jy, jc = JL.mla_decode(p, jcfg, jnp.asarray(x), jc, jnp.asarray(pos),
                               cos, sin, lora=lo)
        py, pc = PL.mla_decode(interop.from_numpy_tree(p), pcfg,
                               torch.from_numpy(x), pc, torch.from_numpy(pos),
                               torch.from_numpy(np.asarray(cos)),
                               torch.from_numpy(np.asarray(sin)),
                               lora=interop.from_numpy_tree(lo))
        _close(py, jy)
        pos = pos + 1
    hd = m.kv_lora_rank + m.qk_rope_head_dim
    assert calls == [("flash_decode", "pallas", (b, 1, jcfg.n_heads, hd),
                      (b, cap, 1, hd), (b, cap, 1, m.kv_lora_rank))] * 4


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
    jp, jl = (jax.tree.map(jnp.asarray, t) for t in (params, lora))
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
        assert got.any(), path                # every layer's latent moved
        _close(got, want)


def test_prefill_matches_decode(test_spec):
    """The training formulation (k and v expanded from the latent) and
    the absorbed one (attention over the latent) give the same last-token
    logits, with a shared 2-D adapter on both up-projections."""
    _, pcfg = _cfgs(test_spec)
    jcfg, _ = _cfgs(test_spec)
    params, lora, batch = _setup(jcfg, _rng("pvd"), seq=20)
    pp, pl = interop.from_numpy_tree(params), interop.from_numpy_tree(lora)
    tokens = torch.from_numpy(batch["tokens"])
    want = PT.prefill(pcfg, pp, pl, batch)
    cache = PT.init_cache(pcfg, 2, 20, torch.float32, "cpu")
    for i in range(tokens.shape[1]):
        got, cache = PT.decode_step(pcfg, pp, pl, tokens[:, i:i + 1], cache)
    live = slice(0, pcfg.vocab)
    _close(got[..., live], want[..., live].numpy())


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


def test_devft_submodel_matches_jax(test_spec):
    """A DevFT-like submodel: the dense prefix and the MoE stack cut to
    one layer each (the stage's ``_sub_cfg``: 2 layers, 1 dense):
    prefill, loss and every LoRA gradient against JAX."""
    from repro.core.devft import _sub_cfg as jax_sub_cfg
    from repro_torch.core.devft import _sub_cfg
    jcfg, pcfg = _cfgs(test_spec)
    params, lora, batch = _setup(jcfg, _rng("submodel"), seq=16)
    caps = {"dense": 1, "moe": 1}
    params["blocks"] = {name: jax.tree.map(lambda a, n=caps[name]: a[:n],
                                           stack)
                        for name, stack in params["blocks"].items()}
    lora = {name: jax.tree.map(lambda a, n=caps[name]: a[:n], stack)
            for name, stack in lora.items()}
    jsub, psub = jax_sub_cfg(jcfg, caps), _sub_cfg(pcfg, caps)
    assert (psub.n_layers, psub.moe.first_dense_layers) \
        == (jsub.n_layers, jsub.moe.first_dense_layers) == (2, 1)
    jp, jl, jb = (jax.tree.map(jnp.asarray, t) for t in (params, lora, batch))
    pp, pl = interop.from_numpy_tree(params), interop.from_numpy_tree(lora)
    _close(PT.prefill(psub, pp, pl, batch), jax.jit(
        lambda p, lo, bt: JT.prefill(jsub, p, lo, bt))(jp, jl, jb))
    (jt, _), jg = jax.jit(jax.value_and_grad(
        lambda lo, p, bt: JT.loss_fn(jsub, p, lo, bt), has_aux=True))(
        jl, jp, jb)
    pt, _, pg = PT.loss_and_lora_grads(psub, pp, pl, batch)
    np.testing.assert_allclose(float(pt), float(jt), rtol=TOL, atol=TOL)
    for (path, g), w in zip(interop.tree_paths(pg), jax.tree.leaves(jg)):
        assert tuple(g.shape) == w.shape, path
        _close(g, w, GRAD_TOL)


@pytest.mark.parametrize("sizes", [None, {"dense": 2, "moe": 5},
                                   {"dense": 1, "moe": 1}])
def test_dense_prefix_runs_before_the_moe_stack(sizes):
    """deepseek-v3's execution order: the dense prefix, then the MoE
    layers, for the full config and for submodels."""
    pcfg, jcfg = get_config(ARCH), jax_get_config(ARCH)
    order = PT.execution_order(pcfg, sizes)
    assert order == [tuple(x) for x in JT.execution_order(jcfg, sizes)]
    names = [name for name, _ in order]
    n_dense = names.count("dense")
    assert names == ["dense"] * n_dense + ["moe"] * (len(names) - n_dense)
    if sizes is None:
        assert (n_dense, len(names)) == (3, 61)


def test_shared_expert_at_deepseek_width_matches_jax():
    """``moe_block`` at deepseek-v3's widths (d 7168, expert and shared
    expert ff 2048), the routed experts cut to 2 (top 1) to fit the
    test: the shared expert's SwiGLU added to every token's output, f32,
    against JAX."""
    from repro.models import moe as JM
    from repro_torch.models import moe as PM
    full = get_config(ARCH)
    assert (full.d_model, full.moe.d_ff_expert,
            full.moe.n_shared_experts) == (7168, 2048, 1)
    moe = dataclasses.replace(full.moe, n_experts=2, top_k=1)
    pcfg = dataclasses.replace(full, moe=moe, dtype="float32",
                               kernel_backend="reference")
    jcfg = dataclasses.replace(jax_get_config(ARCH), moe=dataclasses.replace(
        jax_get_config(ARCH).moe, n_experts=2, top_k=1), dtype="float32",
        kernel_backend="reference")
    rng = _rng("shared-expert")
    d, ff = 7168, 2048

    def w(*shape, std):
        return (rng.standard_normal(shape, dtype=np.float32) * std)
    params = {"router": w(d, 2, std=d ** -0.5),
              "wg": w(2, d, ff, std=d ** -0.5), "wu": w(2, d, ff, std=d ** -0.5),
              "wd": w(2, ff, d, std=ff ** -0.5),
              "shared": {"wg": w(d, ff, std=d ** -0.5),
                         "wu": w(d, ff, std=d ** -0.5),
                         "wd": w(ff, d, std=ff ** -0.5)}}
    x = w(8, d, std=1.0)
    want, want_aux = JM.moe_block(jax.tree.map(jnp.asarray, params), jcfg,
                                  jnp.asarray(x))
    got, aux = PM.moe_block(interop.from_numpy_tree(params), pcfg,
                            torch.from_numpy(x))
    _close(got, want)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)
    # the shared expert's share: without it the outputs differ by it
    del params["shared"]
    routed, _ = PM.moe_block(interop.from_numpy_tree(params), pcfg,
                             torch.from_numpy(x))
    assert float((got - routed).abs().max()) > 0.1


def test_kv_manager_resets_the_latent_lanes(test_spec):
    """Recycling a slot zeroes its ``c`` and ``k_rope`` lanes in every
    layer and its cursor; the other slots keep theirs."""
    from repro_torch.serving.kv_cache import KVCacheManager
    _, pcfg = _cfgs(test_spec)
    kv = KVCacheManager(pcfg, n_slots=3, capacity=6, dtype=torch.float32,
                        device="cpu")
    leaves = interop.tree_leaves(kv.cache["stacks"])
    assert sorted(kv.cache["stacks"]["dense"]["mixer"]) == ["c", "k_rope"]
    for leaf in leaves:
        leaf.fill_(1.0)
    kv.cache["pos"][:] = torch.tensor([4, 2, 5], dtype=torch.int32)
    kv.reset_slot(1)
    for leaf in leaves:
        assert not leaf[:, 1].any() and bool((leaf[:, [0, 2]] == 1).all())
    assert kv.positions().tolist() == [4, 0, 5]
