"""The PyTorch port's training forward and backward against the JAX
package: ``loss_fn`` and the LoRA gradients (``jax.value_and_grad`` of
the JAX ``loss_fn``) on reduced ``llama2-7b-proxy`` and ``qwen2-7b``
(GQA, qkv bias), ``remat=True``, and ``prefill``.

Two numerics, compared like with like:

* the port's CPU model (the plain math) against the JAX package's
  ``reference`` backend;
* the port's kernel branches — forced on the CPU by making
  ``dispatch.use_kernel`` true, so ``_proj`` and ``attend`` go through
  the ``lora_matmul`` / ``flash_attention`` autograd Functions, which run
  their plain versions on CPU tensors — against the JAX package's
  ``pallas`` backend (Pallas in interpret mode, ``custom_vjp``).

Parameters are made by the JAX package and cross through numpy; LoRA
``b`` is random (``init_lora`` zeroes it, which would leave the adapter
gradient of ``a`` zero); tokens and labels are numpy from a seed, one
label -1 (masked).

Tolerances: f32 rtol = atol = 1e-4 (summation order only; measured
differences are ~1e-6 relative). bf16: both frameworks round every
activation to bf16 but at different points (XLA keeps f32 inside fused
elementwise chains), so the loss agrees to one bf16 ulp of its size,
2**-8 relative (measured <= 3.5e-4 relative; the loss reads bf16
logits), and each gradient leaf to 5e-2 of its norm and
of its largest entry (measured ~1.5e-2 of the norm: rounding
accumulated over the layers and the backward).
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
from repro_torch import interop
from repro_torch.configs import ReducedSpec, get_config, reduce_config
from repro_torch.kernels import dispatch
from repro_torch.launch import steps as psteps
from repro_torch.models import transformer as PT

torch.set_num_threads(1)

ARCHS = ["llama2-7b-proxy", "qwen2-7b"]


def _cfgs(arch, test_spec, dtype="float32", backend="reference"):
    jcfg = dataclasses.replace(jax_reduce_config(jax_get_config(arch),
                                                 test_spec),
                               dtype=dtype, kernel_backend=backend)
    pcfg = dataclasses.replace(
        reduce_config(get_config(arch),
                      ReducedSpec(**dataclasses.asdict(test_spec))),
        dtype=dtype, kernel_backend=backend)
    return jcfg, pcfg


def _setup(jcfg, key, rank=4, batch=2, seq=16):
    """numpy params (in the config's dtype), an f32 LoRA with random
    ``b``, and a token batch with one masked label."""
    rng = np.random.default_rng(np.random.SeedSequence(
        [int.from_bytes(str(key).encode(), "big")]))
    params = jax.tree.map(
        lambda a: np.asarray(jnp.asarray(a).astype(jcfg.dtype)),
        JT.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32))
    lora = jax.tree.map(
        lambda a: (0.05 * rng.standard_normal(a.shape)).astype(np.float32),
        JT.init_lora(jcfg, jax.random.PRNGKey(1), rank=rank))
    tokens = rng.integers(0, jcfg.vocab, (batch, seq)).astype(np.int32)
    labels = rng.integers(0, jcfg.vocab, (batch, seq)).astype(np.int32)
    labels[0, 3] = -1
    return params, lora, {"tokens": tokens, "labels": labels}


def _jax_value_and_grad(jcfg, params, lora, batch, **kw):
    (total, metrics), grads = jax.value_and_grad(
        lambda lo: JT.loss_fn(jcfg, jax.tree.map(jnp.asarray, params), lo,
                              jax.tree.map(jnp.asarray, batch), **kw),
        has_aux=True)(jax.tree.map(jnp.asarray, lora))
    return total, metrics, grads


def _check(got, want, dtype):
    (pt, pm, pg), (jt, jm, jg) = got, want
    if dtype == "float32":
        for g, w in [(pt, jt)] + [(pm[k], jm[k]) for k in ("loss", "acc")]:
            np.testing.assert_allclose(float(g), float(w), rtol=1e-4,
                                       atol=1e-4)
    else:
        assert abs(float(pt) - float(jt)) <= 2.0 ** -8 * abs(float(jt))
    leaves = interop.tree_paths(pg)
    assert [p for p, _ in leaves] == [
        tuple(k.key for k in path)
        for path, _ in jax.tree_util.tree_flatten_with_path(jg)[0]]
    for (_, g), w in zip(leaves, jax.tree.leaves(jg)):
        assert g.dtype == torch.float32          # the leaves' dtype
        g, w = g.numpy(), np.asarray(w, np.float32)
        if dtype == "float32":
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
        else:
            assert np.linalg.norm(g - w) <= 5e-2 * np.linalg.norm(w)
            assert np.abs(g - w).max() <= 5e-2 * np.abs(w).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_lora_grads_match_jax_reference(arch, dtype, test_spec):
    jcfg, pcfg = _cfgs(arch, test_spec, dtype)
    params, lora, batch = _setup(jcfg, ("ref", arch, dtype))
    got = PT.loss_and_lora_grads(pcfg, interop.from_numpy_tree(params),
                                 interop.from_numpy_tree(lora), batch)
    assert float(got[1]["aux"]) == 0.0
    _check(got, _jax_value_and_grad(jcfg, params, lora, batch), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_kernel_branch_matches_jax_pallas(arch, dtype, test_spec,
                                          monkeypatch):
    """Both model branches through the autograd Functions: every layer's
    W_q/W_v projection through ``lora_matmul`` and its attention through
    ``flash_attention``, forward and backward."""
    jcfg, pcfg = _cfgs(arch, test_spec, dtype, backend="pallas")
    params, lora, batch = _setup(jcfg, ("pallas", arch, dtype))
    calls = []
    real = {name: getattr(PT.Lyr.ops, name)
            for name in ("lora_matmul", "flash_attention")}
    for name, fn in real.items():
        monkeypatch.setattr(PT.Lyr.ops, name,
                            lambda *a, _n=name, _f=fn, **k:
                            calls.append(_n) or _f(*a, **k))
    monkeypatch.setattr(dispatch, "use_kernel", lambda backend, device: True)
    got = PT.loss_and_lora_grads(pcfg, interop.from_numpy_tree(params),
                                 interop.from_numpy_tree(lora), batch)
    n = pcfg.n_layers
    assert calls.count("lora_matmul") == 2 * n
    assert calls.count("flash_attention") == n
    _check(got, _jax_value_and_grad(jcfg, params, lora, batch), dtype)


def test_remat_gives_the_same_gradients(test_spec):
    _, pcfg = _cfgs("llama2-7b-proxy", test_spec)
    jcfg, _ = _cfgs("llama2-7b-proxy", test_spec)
    params, lora, batch = _setup(jcfg, "remat")
    p, lo = interop.from_numpy_tree(params), interop.from_numpy_tree(lora)
    plain = PT.loss_and_lora_grads(pcfg, p, lo, batch)
    remat = PT.loss_and_lora_grads(pcfg, p, lo, batch, remat=True)
    assert torch.equal(plain[0], remat[0])
    for a, b in zip(interop.tree_leaves(plain[2]),
                    interop.tree_leaves(remat[2])):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    with pytest.raises(NotImplementedError, match="checkpoint"):
        PT.loss_fn(pcfg, p, lo, batch,
                   remat="dots_with_no_batch_dims_saveable")


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_match_jax(arch, test_spec):
    jcfg, pcfg = _cfgs(arch, test_spec)
    params, lora, batch = _setup(jcfg, ("prefill", arch))
    want = JT.prefill(jcfg, jax.tree.map(jnp.asarray, params),
                      jax.tree.map(jnp.asarray, lora),
                      {"tokens": jnp.asarray(batch["tokens"])})
    got = psteps.make_prefill_step(pcfg)(
        interop.from_numpy_tree(params), interop.from_numpy_tree(lora),
        {"tokens": batch["tokens"]})
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_train_step_matches_jax(test_spec):
    """One global AdamW step (``make_train_step``, remat on by default)."""
    from repro.launch import steps as jsteps
    from repro.optim.adamw import init_adamw as jinit
    from repro_torch.optim.adamw import init_adamw as pinit

    jcfg, pcfg = _cfgs("qwen2-7b", test_spec)
    params, lora, batch = _setup(jcfg, "train-step")
    lr = 1e-3
    jlora, _, jm = jsteps.make_train_step(jcfg)(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, lora),
        jinit(jax.tree.map(jnp.asarray, lora)),
        jax.tree.map(jnp.asarray, batch), lr)
    plora = interop.from_numpy_tree(lora)
    got, opt, pm = psteps.make_train_step(pcfg)(
        interop.from_numpy_tree(params), plora, pinit(plora), batch, lr)
    assert int(opt.count) == 1
    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                               rtol=1e-4, atol=1e-4)
    # AdamW's first step moves every element by ~lr whatever its
    # gradient's size: the leaves at 2 * lr (see test_torch_federated);
    # the update itself, on the elements whose JAX gradient is clearly
    # above noise (|g| > 1e-4 max|g|; the gradients agree to ~1e-6
    # relative), within 1e-3 * lr of JAX's: f32 rounding of the leaf, while
    # a skipped update or a flipped sign is off by ~lr
    _, _, jgrads = _jax_value_and_grad(jcfg, params, lora, batch)
    for g, w, b, jg in zip(interop.tree_leaves(got), jax.tree.leaves(jlora),
                           jax.tree.leaves(lora), jax.tree.leaves(jgrads)):
        g, w, jg = g.numpy(), np.asarray(w), np.abs(np.asarray(jg))
        np.testing.assert_allclose(g, w, rtol=0, atol=2 * lr)
        clear = jg > 1e-4 * jg.max()
        assert clear.mean() > 0.9
        np.testing.assert_allclose((g - b)[clear], (w - b)[clear], rtol=0,
                                   atol=1e-3 * lr)
