"""The PyTorch port's whisper-tiny encoder-decoder order against the JAX
package.

On reduced whisper-tiny (``reduce_config``: 2 ``enc`` and 2 ``dec``
layers, or 4 ``dec`` for the DevFT case; d 128, MHA 4/4, hd 32, an
8-frame audio stub), f32, with parameters crossed from the JAX package
through numpy:

* ``encoder_kv``: the frozen encoder (non-causal, rotary tables over the
  frame positions), ``enc_norm`` and each decoder layer's cross K/V,
  against the JAX package's own steps (``_run_stack`` over ``enc``, then
  the cross projections);
* ``loss_fn`` and every LoRA gradient (``dec`` only: the encoder has no
  adapter) with ``audio_embeds``: the plain path against JAX's
  ``reference`` backend, and the kernel branches forced on the CPU
  (``dispatch.use_kernel`` true: the encoder's non-causal attention and
  the decoder's causal self-attention through ``flash_attention``, W_q
  and W_v of the decoder through ``lora_matmul``; the cross-attention,
  Sq != Senc, plain as JAX's ``_flash_eligible`` keeps it) against JAX's
  ``pallas`` backend in interpret mode; the plain path also with
  ``remat=True`` (each ``dec`` block checkpointed over its own cross
  K/V);
* ``decode_step`` for several steps from a cache whose self-attention
  rows and cross-attention K/V are seeded nonzero (with the zero cross
  caches the engine makes, a wrong head layout or a transposed ``wk`` in
  the cross branch would give the same result as the right one);
  prefill's last-token logits against teacher-forced decoding with the
  cross cache filled from ``encoder_kv``;
* ``build_submodel`` at capacities 1-4 over a 4-layer decoder: group
  lists exactly equal, the encoder carried whole (the same tensors),
  the fused decoder and the submodel's loss against JAX's;
* ``run_experiment`` raises ``KeyError('audio_embeds')`` in both
  packages (their federated data carry no audio);
* the serving engine's greedy tokens equal to the JAX engine's, with
  two adapters and slot recycling (zero cross caches in both, as both
  engines make them).

Tolerances: f32 rtol = atol = 1e-5 for forward values, 1e-4 for
gradients (summation order only; the other port files' limits); the
submodel's loss at ``check_trajectory``'s rel = abs = 1e-3; integers
exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduce_config as jax_reduce_config
from repro.core import devft as JD
from repro.experiments import get_preset as jax_get_preset
from repro.experiments import run_experiment as jax_run_experiment
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.serving import AdapterRegistry as JaxRegistry
from repro.serving import ServingEngine as JaxEngine
from repro_torch import interop
from repro_torch.configs import ReducedSpec, get_config, reduce_config
from repro_torch.core import devft as PD
from repro_torch.experiments import get_preset, run_experiment
from repro_torch.kernels import dispatch
from repro_torch.models import transformer as PT
from repro_torch.serving import AdapterRegistry, ServingEngine

torch.set_num_threads(1)

ARCH = "whisper-tiny"
TOL = 1e-5
GRAD_TOL = 1e-4


def _cfgs(test_spec, backend="reference", **spec):
    kw = dict(dataclasses.asdict(test_spec), **spec)
    jcfg = jax_reduce_config(jax_get_config(ARCH), type(test_spec)(**kw))
    pcfg = reduce_config(get_config(ARCH), ReducedSpec(**kw))
    return (dataclasses.replace(jcfg, dtype="float32", kernel_backend=backend),
            dataclasses.replace(pcfg, dtype="float32", kernel_backend=backend))


def _rng(*key):
    return np.random.default_rng(np.random.SeedSequence(
        [sum(map(ord, str(k))) for k in key]))


def _setup(jcfg, rng, batch=2, seq=12):
    """numpy params (norm scales perturbed), an f32 LoRA with random
    ``b`` and a batch with one masked label and the audio frames."""
    params = JT.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)

    def draw(path, a):
        a = np.asarray(a)
        if getattr(path[-1], "key", "") in ("ln1", "ln2", "lnx", "enc_norm"):
            a = a + 0.1 * rng.standard_normal(a.shape).astype(np.float32)
        return a
    params = jax.tree_util.tree_map_with_path(draw, params)
    lora = jax.tree.map(
        lambda a: (0.05 * rng.standard_normal(a.shape)).astype(np.float32),
        JT.init_lora(jcfg, jax.random.PRNGKey(1), rank=4))
    out = {key: rng.integers(0, jcfg.vocab, (batch, seq)).astype(np.int32)
           for key in ("tokens", "labels")}
    out["audio_embeds"] = rng.standard_normal(
        (batch, jcfg.n_frontend_tokens, jcfg.d_model)).astype(np.float32)
    out["labels"][0, 2] = -1
    return params, lora, out


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _jax_encoder_kv(jcfg, params, audio):
    """The JAX package's enc-dec branch up to the cross K/V
    (``transformer.forward_hidden``, its steps taken one by one)."""
    p = jax.tree.map(jnp.asarray, params)
    b, se = audio.shape[:2]
    cos, sin = JL.rope_cos_sin(JL.text_positions(b, se), jcfg.hd,
                               jcfg.rope_theta)
    h, _ = JT._run_stack(jcfg, p["blocks"]["enc"], "enc", jnp.asarray(audio),
                         cos, sin, None, causal=False)
    h = JL.rms_norm(h, p["enc_norm"], jcfg.norm_eps)
    cross = p["blocks"]["dec"]["cross"]
    shape = (-1, b, se, jcfg.n_kv_heads, jcfg.hd)
    return (jnp.einsum("bsd,lde->lbse", h, cross["wk"]).reshape(shape),
            jnp.einsum("bsd,lde->lbse", h, cross["wv"]).reshape(shape))


def test_encoder_kv_matches_jax(test_spec):
    jcfg, pcfg = _cfgs(test_spec)
    params, _, batch = _setup(jcfg, _rng("encoder"))
    jk, jv = _jax_encoder_kv(jcfg, params, batch["audio_embeds"])
    pk, pv = PT.encoder_kv(pcfg, interop.from_numpy_tree(params),
                           batch["audio_embeds"])
    assert tuple(pk.shape) == jk.shape == (
        pcfg.n_layers, 2, pcfg.n_frontend_tokens, pcfg.n_kv_heads, pcfg.hd)
    _close(pk, jk)
    _close(pv, jv)


def _jax_value_and_grad(jcfg, params, lora, batch):
    (total, metrics), grads = jax.jit(jax.value_and_grad(
        lambda lo, p, bt: JT.loss_fn(jcfg, p, lo, bt), has_aux=True))(
        *(jax.tree.map(jnp.asarray, t) for t in (lora, params, batch)))
    return total, metrics, grads


def _check(got, want):
    (pt, pm, pg), (jt, jm, jg) = got, want
    for g, w in [(pt, jt)] + [(pm[k], jm[k]) for k in ("loss", "acc")]:
        np.testing.assert_allclose(float(g), float(w), rtol=TOL, atol=TOL)
    paths = interop.tree_paths(pg)
    assert [p for p, _ in paths] == [
        tuple(k.key for k in path)
        for path, _ in jax.tree_util.tree_flatten_with_path(jg)[0]]
    assert {p[0] for p, _ in paths} == {"dec"}
    for (path, g), w in zip(paths, jax.tree.leaves(jg)):
        assert float(np.abs(np.asarray(w)).max()) > 0, path
        _close(g, w, GRAD_TOL)


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_lora_grads_match_jax(remat, test_spec):
    jcfg, pcfg = _cfgs(test_spec)
    params, lora, batch = _setup(jcfg, _rng("grads"))
    got = PT.loss_and_lora_grads(pcfg, interop.from_numpy_tree(params),
                                 interop.from_numpy_tree(lora), batch,
                                 remat=remat)
    _check(got, _jax_value_and_grad(jcfg, params, lora, batch))


def test_kernel_branch_matches_jax_pallas(test_spec, monkeypatch):
    """The encoder's non-causal attention and the decoder's causal
    self-attention through ``flash_attention``, the decoder's W_q/W_v
    through ``lora_matmul``, forward and backward, against JAX's Pallas
    kernels in interpret mode; the encoder has no adapter, so its
    projections stay plain, and so does the cross-attention."""
    jcfg, pcfg = _cfgs(test_spec, backend="pallas")
    params, lora, batch = _setup(jcfg, _rng("pallas"))
    calls = []
    for name in ("lora_matmul", "flash_attention"):
        real = getattr(PT.Lyr.ops, name)
        monkeypatch.setattr(PT.Lyr.ops, name,
                            lambda *a, _n=name, _f=real, **k:
                            calls.append((_n, k.get("causal"),
                                          tuple(a[0].shape))) or _f(*a, **k))
    monkeypatch.setattr(dispatch, "use_kernel", lambda backend, device: True)
    got = PT.loss_and_lora_grads(pcfg, interop.from_numpy_tree(params),
                                 interop.from_numpy_tree(lora), batch)
    heads = (pcfg.n_heads, pcfg.hd)
    assert [c for c in calls if c[0] == "flash_attention"] == \
        [("flash_attention", False, (2, pcfg.n_frontend_tokens, *heads))] \
        * pcfg.n_enc_layers + [("flash_attention", True, (2, 12, *heads))] \
        * pcfg.n_layers
    assert [c[2] for c in calls if c[0] == "lora_matmul"] == [
        (2, 12, pcfg.d_model)] * 2 * pcfg.n_layers
    _check(got, _jax_value_and_grad(jcfg, params, lora, batch))


def test_decode_step_with_a_seeded_cross_cache_matches_jax(test_spec):
    jcfg, pcfg = _cfgs(test_spec)
    rng = _rng("decode")
    b, cap, steps = 3, 10, 5
    params, _, _ = _setup(jcfg, rng)
    lora = jax.tree.map(
        lambda a: (0.05 * rng.standard_normal(
            (a.shape[0], b) + a.shape[1:])).astype(np.float32),
        JT.init_lora(jcfg, jax.random.PRNGKey(1), rank=4))
    cache = jax.tree.map(np.asarray, JT.init_cache(jcfg, b, cap, jnp.float32))
    assert sorted(cache["stacks"]["dec"]) == ["cross_k", "cross_v", "mixer"]
    cache["stacks"] = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32),
        cache["stacks"])
    cache["pos"] = np.array([0, 2, 5], np.int32)
    jc = jax.tree.map(jnp.asarray, cache)
    pc = interop.from_numpy_tree(cache)
    step = jax.jit(lambda p, lo, tok, c: JT.decode_step(jcfg, p, lo, tok, c))
    jp, jl = (jax.tree.map(jnp.asarray, t) for t in (params, lora))
    pp, pl = interop.from_numpy_tree(params), interop.from_numpy_tree(lora)
    for _ in range(steps):
        tok = rng.integers(0, jcfg.vocab, (b, 1)).astype(np.int32)
        jlog, jc = step(jp, jl, jnp.asarray(tok), jc)
        plog, pc = PT.decode_step(pcfg, pp, pl, torch.from_numpy(tok), pc)
        _close(plog[..., :jcfg.vocab], np.asarray(jlog)[..., :jcfg.vocab])
    np.testing.assert_array_equal(pc["pos"].numpy(), np.asarray(jc["pos"]))
    for (path, got), want in zip(interop.tree_paths(pc["stacks"]),
                                 jax.tree.leaves(jc["stacks"])):
        _close(got, want)


def test_prefill_matches_decode_with_the_encoder_in_the_cross_cache(
        test_spec):
    """The whole-sequence formulation (the encoder run inside
    ``forward_hidden``) against teacher-forced decoding over a cross
    cache filled from ``encoder_kv``, with a shared 2-D adapter."""
    jcfg, pcfg = _cfgs(test_spec)
    params, lora, batch = _setup(jcfg, _rng("pvd"))
    pp, pl = interop.from_numpy_tree(params), interop.from_numpy_tree(lora)
    want = PT.prefill(pcfg, pp, pl, batch)
    jwant = JT.prefill(jcfg, *(jax.tree.map(jnp.asarray, t)
                               for t in (params, lora, batch)))
    _close(want, jwant)
    tokens = torch.from_numpy(batch["tokens"])
    cache = PT.init_cache(pcfg, 2, tokens.shape[1], torch.float32, "cpu")
    dec = cache["stacks"]["dec"]
    dec["cross_k"][:], dec["cross_v"][:] = PT.encoder_kv(
        pcfg, pp, batch["audio_embeds"])
    for i in range(tokens.shape[1]):
        got, cache = PT.decode_step(pcfg, pp, pl, tokens[:, i:i + 1], cache)
    live = slice(0, pcfg.vocab)
    _close(got[..., live], want[..., live].numpy())


@pytest.mark.parametrize("capacity", [1, 2, 3, 4])
def test_build_submodel_keeps_the_encoder_whole(capacity, test_spec):
    jcfg, pcfg = _cfgs(test_spec, n_layers=4)
    params, lora, batch = _setup(jcfg, _rng("submodel"))
    pp, pl = interop.from_numpy_tree(params), interop.from_numpy_tree(lora)
    seed = (0, capacity)
    jsub = JD.build_submodel(jcfg, jax.tree.map(jnp.asarray, params),
                             jax.tree.map(jnp.asarray, lora), capacity,
                             seed=seed)
    psub = PD.build_submodel(pcfg, pp, pl, capacity, seed=seed)
    assert psub.plan == jsub.plan and list(psub.plan) == ["dec"]
    assert len(psub.plan["dec"]["groups"]) == capacity
    assert psub.cfg.n_layers == jsub.cfg.n_layers == capacity
    assert psub.cfg.n_enc_layers == pcfg.n_enc_layers
    for a, b in zip(interop.tree_leaves(psub.params["blocks"]["enc"]),
                    interop.tree_leaves(pp["blocks"]["enc"])):
        assert a is b                             # carried, not copied
    assert sorted(psub.lora) == ["dec"]
    for (path, got), want in zip(interop.tree_paths(psub.params),
                                 jax.tree.leaves(jsub.params)):
        _close(got, want)
    jloss, _ = JT.loss_fn(jsub.cfg, jsub.params, jsub.lora,
                          jax.tree.map(jnp.asarray, batch))
    ploss, _ = PT.loss_fn(psub.cfg, psub.params, psub.lora, batch)
    assert float(ploss) == pytest.approx(float(jloss), rel=1e-3, abs=1e-3)


def test_run_experiment_raises_key_error_in_both_packages():
    """The federated data carry no ``audio_embeds``: the runner fails in
    pretraining, as the JAX package's does (no audio feed is added)."""
    for run, preset in ((jax_run_experiment, jax_get_preset),
                        (lambda s: run_experiment(s, device="cpu"),
                         get_preset)):
        with pytest.raises(KeyError, match="audio_embeds"):
            run(preset("bench-tiny").replace(arch=ARCH))


def test_engine_tokens_equal_jax_with_recycling(test_spec):
    jcfg, pcfg = _cfgs(test_spec)
    rng = _rng("engine")
    params, _, _ = _setup(jcfg, rng)
    adapters = [jax.tree.map(
        lambda a: (0.05 * rng.standard_normal(a.shape)).astype(np.float32),
        JT.init_lora(jcfg, jax.random.PRNGKey(i), rank=4)) for i in range(2)]
    prompts = [rng.integers(0, jcfg.vocab, n).astype(np.int32)
               for n in (5, 3, 6, 4)]
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
        reqs = [eng.submit(p, max_new_tokens=4, adapter=f"a{i % 2}")
                for i, p in enumerate(prompts)]
        while eng.has_work():
            eng.step()
        toks.append([r.tokens for r in reqs])
    for jt, pt in zip(*toks):
        assert len(pt) == 4
        np.testing.assert_array_equal(pt, jt)
