"""The port's named remat policies against the JAX package's
``jax.checkpoint_policies``: ``loss_fn`` and the LoRA gradients under
each of the six plain names on reduced llama2-7b-proxy, granite-moe
(MoE), mamba2 (Mamba-2), jamba (the hybrid order, 8 layers: the JAX
package cannot build fewer) and whisper-tiny (the encoder-decoder
order), f32 on the ``reference`` backend.

* Against JAX: the loss to 1e-4 and every gradient leaf to rtol = atol =
  1e-4, the train-parity tolerance (``test_torch_train.py``). A policy
  and its alias are one function in JAX (``checkpoint_dots is
  dots_saveable``), so JAX runs once per function.
* Against the port's own ``remat=False``: a policy only chooses what is
  kept for the backward, so the loss is bit-equal and the gradients agree
  to rounding.
* What the backward recomputes: a dispatch mode entered around the step
  sits below the selective-checkpoint mode that the recompute pushes, so
  it sees only the ops that really run again, not the outputs served from
  the policy's cache. The test counts the matmul FLOPs (``mm``, ``addmm``,
  ``bmm``, ``baddbmm``) it sees inside ``block_forward`` while the
  backward runs: ``nothing_saveable`` = ``True`` > ``dots_with_no_batch_
  dims_saveable`` >= ``dots_saveable`` >= ``everything_saveable`` = 0.
* A factory policy (built from arguments in JAX) and an unknown name
  raise.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as jax_get_config
from repro.configs import reduce_config as jax_reduce_config
from repro.models import transformer as JT
from repro_torch import interop
from repro_torch.configs import ReducedSpec, get_config, reduce_config
from repro_torch.models import transformer as PT

torch.set_num_threads(1)

ARCHS = ["llama2-7b-proxy", "granite-moe-1b-a400m", "mamba2-2.7b",
         "jamba-v0.1-52b", "whisper-tiny"]
NAMES = ["everything_saveable", "nothing_saveable", "dots_saveable",
         "checkpoint_dots", "dots_with_no_batch_dims_saveable",
         "checkpoint_dots_with_no_batch_dims"]


def _canonical(name):
    """The first of NAMES that is the same JAX policy function."""
    fn = getattr(jax.checkpoint_policies, name)
    return next(n for n in NAMES
                if getattr(jax.checkpoint_policies, n) is fn)


@functools.lru_cache(maxsize=None)
def _case(arch, test_spec):
    jcfg = dataclasses.replace(jax_reduce_config(jax_get_config(arch),
                                                 test_spec),
                               dtype="float32", kernel_backend="reference")
    pcfg = dataclasses.replace(
        reduce_config(get_config(arch),
                      ReducedSpec(**dataclasses.asdict(test_spec))),
        dtype="float32", kernel_backend="reference")
    rng = np.random.default_rng(np.random.SeedSequence(
        [int.from_bytes(arch.encode(), "big")]))
    params = jax.tree.map(np.asarray, JT.init_params(
        jcfg, jax.random.PRNGKey(0), jnp.float32))
    lora = jax.tree.map(
        lambda a: (0.05 * rng.standard_normal(a.shape)).astype(np.float32),
        JT.init_lora(jcfg, jax.random.PRNGKey(1), rank=4))
    batch = {"tokens": rng.integers(0, jcfg.vocab, (2, 16)).astype(np.int32),
             "labels": rng.integers(0, jcfg.vocab, (2, 16)).astype(np.int32)}
    batch["labels"][0, 3] = -1
    if jcfg.frontend == "audio":
        batch["audio_embeds"] = rng.standard_normal(
            (2, jcfg.n_frontend_tokens, jcfg.d_model)).astype(np.float32)
    return jcfg, pcfg, params, lora, batch


@functools.lru_cache(maxsize=None)
def _jax(arch, name, test_spec):
    jcfg, _, params, lora, batch = _case(arch, test_spec)
    p = jax.tree.map(jnp.asarray, params)
    b = jax.tree.map(jnp.asarray, batch)
    (total, _m), grads = jax.jit(jax.value_and_grad(
        lambda lo: JT.loss_fn(jcfg, p, lo, b, remat=name),
        has_aux=True))(jax.tree.map(jnp.asarray, lora))
    return float(total), [np.asarray(g) for g in jax.tree.leaves(grads)]


def _port(arch, remat, test_spec):
    _, pcfg, params, lora, batch = _case(arch, test_spec)
    total, _m, grads = PT.loss_and_lora_grads(
        pcfg, interop.from_numpy_tree(params), interop.from_numpy_tree(lora),
        batch, remat=remat)
    return total, interop.tree_leaves(grads)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("arch", ARCHS)
def test_named_policy_matches_jax(arch, name, test_spec):
    total, grads = _port(arch, name, test_spec)
    want_total, want_grads = _jax(arch, _canonical(name), test_spec)
    np.testing.assert_allclose(float(total), want_total, rtol=1e-4,
                               atol=1e-4)
    assert len(grads) == len(want_grads)
    for g, w in zip(grads, want_grads):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_named_policies_agree_with_no_remat(arch, test_spec):
    base_total, base_grads = _port(arch, False, test_spec)
    for name in [True] + NAMES:
        total, grads = _port(arch, name, test_spec)
        assert torch.equal(total, base_total), name
        for g, w in zip(grads, base_grads):
            torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-7)


_aten = torch.ops.aten


def _dot_flops(func, args) -> int:
    packet = func.overloadpacket
    if packet in (_aten.mm, _aten.bmm):
        a, b = args[0], args[1]
    elif packet in (_aten.addmm, _aten.baddbmm):
        a, b = args[1], args[2]
    else:
        return 0
    return 2 * a.numel() * b.shape[-1]


class _RecomputeCounter(TorchDispatchMode):
    """Matmul FLOPs of the ops that run inside ``block_forward`` while
    the backward runs (``in_block`` and ``in_backward`` are set by the
    test); entered before the step, so it sits below the recompute's
    selective-checkpoint mode and never sees its cache hits."""

    def __init__(self):
        super().__init__()
        self.in_block = 0
        self.in_backward = False
        self.flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if self.in_block and self.in_backward:
            self.flops += _dot_flops(func, args)
        return func(*args, **(kwargs or {}))


def _recomputed_flops(arch, remat, test_spec, monkeypatch):
    _, pcfg, params, lora, batch = _case(arch, test_spec)
    counter = _RecomputeCounter()
    block_forward = PT.block_forward

    def counted(*args, **kwargs):
        counter.in_block += 1
        try:
            return block_forward(*args, **kwargs)
        finally:
            counter.in_block -= 1

    monkeypatch.setattr(PT, "block_forward", counted)
    p = interop.from_numpy_tree(params)
    lo = interop.tree_map(lambda t: t.requires_grad_(True),
                          interop.from_numpy_tree(lora))
    with counter:
        total, _m = PT.loss_fn(pcfg, p, lo, batch, remat=remat)
        counter.in_backward = True
        torch.autograd.grad(total, interop.tree_leaves(lo))
    monkeypatch.setattr(PT, "block_forward", block_forward)
    return counter.flops


@pytest.mark.parametrize("arch", ARCHS)
def test_recomputed_matmul_flops_are_ordered(arch, test_spec, monkeypatch):
    got = {name: _recomputed_flops(arch, name, test_spec, monkeypatch)
           for name in [True, False] + NAMES}
    assert got[False] == got["everything_saveable"] == 0
    assert got["nothing_saveable"] == got[True] > 0
    assert got[True] > got["dots_with_no_batch_dims_saveable"] \
        >= got["dots_saveable"] >= got["everything_saveable"]
    assert got["checkpoint_dots"] == got["dots_saveable"]
    assert got["checkpoint_dots_with_no_batch_dims"] \
        == got["dots_with_no_batch_dims_saveable"]


@pytest.mark.parametrize("name", list(PT.FACTORY_POLICIES))
def test_factory_policy_raises(name, test_spec):
    assert hasattr(jax.checkpoint_policies, name)
    _, pcfg, params, lora, batch = _case("llama2-7b-proxy", test_spec)
    with pytest.raises(ValueError, match="built from arguments"):
        PT.loss_fn(pcfg, interop.from_numpy_tree(params),
                   interop.from_numpy_tree(lora), batch, remat=name)


def test_unknown_policy_raises_like_jax(test_spec):
    with pytest.raises(AttributeError):
        getattr(jax.checkpoint_policies, "no_such_policy")
    _, pcfg, params, lora, batch = _case("llama2-7b-proxy", test_spec)
    with pytest.raises(AttributeError, match="no_such_policy"):
        PT.loss_fn(pcfg, interop.from_numpy_tree(params),
                   interop.from_numpy_tree(lora), batch,
                   remat="no_such_policy")


def test_plain_names_are_jaxs():
    """Every plain name is a ``jax.checkpoint_policies`` attribute, and
    the port's two sets cover all of them."""
    public = {n for n in dir(jax.checkpoint_policies)
              if not n.startswith("_")}
    assert set(PT.REMAT_POLICIES) == set(NAMES)
    assert public == set(NAMES) | set(PT.FACTORY_POLICIES)
