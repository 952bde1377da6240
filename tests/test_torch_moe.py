"""The PyTorch port's MoE block (``models/moe.py``) and the ``gqa_moe``
model against the JAX package, on reduced granite-moe-1b-a400m.

* Routing bookkeeping is integer and exactly equal: the top-k experts
  per token, ``_capacity``, each slot's position and keep mask, with a
  ``capacity_factor`` small enough that slots really drop.
* The router's weights and its load-balance loss agree to 1e-6 relative,
  not bit for bit: the softmax's ``exp`` comes from PyTorch's and XLA's
  own CPU kernels, which differ by an f32 ulp.
* ``moe_block``'s output: f32 at 1e-5 (rtol = atol); bf16 at 2**-6 of
  the largest output: the gather and combine are exact rearrangements
  and the k contributions are added in the same order in bf16, so what
  differs is the expert FFN's bf16 roundings (see
  ``test_torch_moe_ffn.py``) and a routing weight one ulp apart before
  its cast to bf16.
* The loss and the LoRA gradients of a reduced granite-moe ``loss_fn``
  against ``jax.value_and_grad`` of the JAX ``reference`` backend, f32,
  at 1e-4 (summation order), the aux loss included.
* The kernel branch, forced on the CPU (``dispatch.use_kernel`` true, so
  the expert FFN goes through the ``moe_expert_ffn`` autograd Function),
  gives the plain path's loss and gradients exactly.
* ``moe_block`` passes each expert's fill (its kept slots, rows 0..fill-1
  of its buffer, computed on the device from the dispatch counts) to the
  expert FFN: its output is the same bits as without the fill, and
  matches JAX ``moe_block`` at the tolerances above.
* ``init_cache`` and ``decode_step`` on ``gqa_moe`` blocks run (their
  parity with the JAX package is ``tests/test_torch_decode_moe.py``).
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
from repro.models import moe as JM
from repro.models import transformer as JT
from repro_torch import interop
from repro_torch.configs import ReducedSpec, get_config, reduce_config
from repro_torch.models import moe as PM
from repro_torch.models import transformer as PT

torch.set_num_threads(1)

ARCH = "granite-moe-1b-a400m"


def _cfgs(test_spec, dtype="float32", capacity_factor=1.25, top_k=2):
    spec = dataclasses.replace(test_spec, top_k=top_k)
    jcfg = jax_reduce_config(jax_get_config(ARCH), spec)
    pcfg = reduce_config(get_config(ARCH),
                         ReducedSpec(**dataclasses.asdict(spec)))
    out = []
    for cfg in (jcfg, pcfg):
        moe = dataclasses.replace(cfg.moe, capacity_factor=capacity_factor)
        out.append(dataclasses.replace(cfg, dtype=dtype, moe=moe,
                                       kernel_backend="reference"))
    return out


def _moe_inputs(jcfg, t, seed=0):
    params = jax.tree.map(
        lambda a: np.asarray(jnp.asarray(a).astype(a.dtype)),
        JM.init_moe(jax.random.PRNGKey(seed), jcfg, jnp.dtype(jcfg.dtype)))
    rng = np.random.default_rng(seed)
    x = np.asarray(jnp.asarray(rng.standard_normal(
        (t, jcfg.d_model)).astype(np.float32)).astype(jcfg.dtype))
    return params, x


@pytest.mark.parametrize("capacity_factor", [1.25, 0.3],
                         ids=["fits", "drops"])
@pytest.mark.parametrize("top_k", [2, 3])
def test_routing_is_exactly_equal(capacity_factor, top_k, test_spec):
    jcfg, pcfg = _cfgs(test_spec, capacity_factor=capacity_factor,
                       top_k=top_k)
    t = 96
    params, x = _moe_inputs(jcfg, t, seed=top_k)
    jw, jidx, jaux = JM.router_topk(jax.tree.map(jnp.asarray, params), jcfg,
                                    jnp.asarray(x))
    pw, pidx, paux = PM.router_topk(interop.from_numpy_tree(params), pcfg,
                                    interop.from_numpy_tree(x))
    np.testing.assert_array_equal(pidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(pw.numpy(), np.asarray(jw), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(float(paux), float(jaux), rtol=1e-6)
    cap = PM._capacity(pcfg, t)
    assert cap == JM._capacity(jcfg, t)
    jpos, jkeep = JM._dispatch_indices(jidx.reshape(-1),
                                       jcfg.moe.n_experts, cap)
    ppos, pkeep, pfill = PM._dispatch_indices(pidx.reshape(-1),
                                              pcfg.moe.n_experts, cap)
    np.testing.assert_array_equal(ppos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(pkeep.numpy(), np.asarray(jkeep))
    # the fill: each expert's kept slots, which take its rows 0..fill-1
    jflat, jk = np.asarray(jidx).reshape(-1), np.asarray(jkeep)
    want_fill = np.bincount(jflat[jk], minlength=jcfg.moe.n_experts)
    assert pfill.dtype == torch.int32
    np.testing.assert_array_equal(pfill.numpy(), want_fill)
    for ex in range(jcfg.moe.n_experts):
        rows = np.sort(np.asarray(jpos)[jk & (jflat == ex)])
        np.testing.assert_array_equal(rows, np.arange(int(pfill[ex])))
    if capacity_factor < 1:
        assert not bool(pkeep.all())             # slots really drop
    else:
        assert bool(pkeep.all())


def test_capacity_rule_matches_jax(test_spec):
    jcfg, pcfg = _cfgs(test_spec)
    for t in (1, 7, 8, 33, 100, 4096):
        assert PM._capacity(pcfg, t) == JM._capacity(jcfg, t)
    full_j, full_p = jax_get_config(ARCH), get_config(ARCH)
    # the full-width training path: B 4 x S 1024 tokens, and the eval batch
    assert PM._capacity(full_p, 4 * 1024) == JM._capacity(full_j, 4096) \
        == 1280
    assert PM._capacity(full_p, 16 * 1024) == 5120


def test_top_k_ties_go_to_the_lower_index(test_spec):
    _, pcfg = _cfgs(test_spec)
    params = {"router": torch.zeros(pcfg.d_model, pcfg.moe.n_experts)}
    _, idx, _ = PM.router_topk(params, pcfg, torch.ones(3, pcfg.d_model))
    assert idx.tolist() == [[0, 1]] * 3
    jcfg, _ = _cfgs(test_spec)
    _, jidx, _ = JM.router_topk(
        {"router": jnp.zeros((jcfg.d_model, jcfg.moe.n_experts))}, jcfg,
        jnp.ones((3, jcfg.d_model)))
    assert np.asarray(jidx).tolist() == idx.tolist()


@pytest.mark.parametrize("capacity_factor", [1.25, 0.3],
                         ids=["fits", "drops"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_block_matches_jax(dtype, capacity_factor, test_spec):
    jcfg, pcfg = _cfgs(test_spec, dtype, capacity_factor)
    params, x = _moe_inputs(jcfg, 64, seed=5)
    jy, jaux = JM.moe_block(jax.tree.map(jnp.asarray, params), jcfg,
                            jnp.asarray(x))
    py, paux = PM.moe_block(interop.from_numpy_tree(params), pcfg,
                            interop.from_numpy_tree(x))
    assert py.dtype == getattr(torch, dtype) and py.shape == x.shape
    np.testing.assert_allclose(float(paux), float(jaux), rtol=1e-6)
    got, want = py.float().numpy(), np.asarray(jy, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert np.abs(got - want).max() <= 2.0 ** -6 * np.abs(want).max()
    # a dropped slot contributes nothing: tokens with every slot dropped
    # come out as exact zeros in both
    _, idx, _ = PM.router_topk(interop.from_numpy_tree(params), pcfg,
                               interop.from_numpy_tree(x))
    _, keep, _ = PM._dispatch_indices(idx.reshape(-1), pcfg.moe.n_experts,
                                      PM._capacity(pcfg, 64))
    gone = ~keep.reshape(64, -1).any(-1).numpy()
    assert gone.any() == (capacity_factor < 1)
    assert (got[gone] == 0).all() and (want[gone] == 0).all()


@pytest.mark.parametrize("capacity_factor", [1.25, 0.3],
                         ids=["fits", "drops"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_block_passes_the_fill(dtype, capacity_factor, test_spec,
                                   monkeypatch):
    jcfg, pcfg = _cfgs(test_spec, dtype, capacity_factor)
    params, x = _moe_inputs(jcfg, 64, seed=9)
    tp, tx = interop.from_numpy_tree(params), interop.from_numpy_tree(x)
    real = PM.expert_ffn_reference
    seen = []

    def spy(buf, wg, wu, wd, *, fill=None):
        seen.append((buf, fill))
        return real(buf, wg, wu, wd, fill=fill)
    monkeypatch.setattr(PM, "expert_ffn_reference", spy)
    py, paux = PM.moe_block(tp, pcfg, tx)
    (buf, fill), = seen
    # the fill: each expert's kept slots, which fill its rows 0..fill-1;
    # the rows past it are zero
    e, cap = pcfg.moe.n_experts, PM._capacity(pcfg, 64)
    _, idx, _ = PM.router_topk(tp, pcfg, tx)
    _, keep, _ = PM._dispatch_indices(idx.reshape(-1), e, cap)
    want = torch.bincount(idx.reshape(-1)[keep], minlength=e)
    assert fill.dtype == torch.int32 and torch.equal(fill.long(), want)
    past = torch.arange(cap)[None, :] >= fill[:, None]
    assert bool((buf[past] == 0).all()) and bool((buf[~past] != 0).any(-1)
                                                 .all())
    assert (capacity_factor < 1) == bool((fill == cap).any())
    # the same bits without it
    monkeypatch.setattr(PM, "expert_ffn_reference",
                        lambda buf, wg, wu, wd, *, fill=None:
                        real(buf, wg, wu, wd))
    py0, _ = PM.moe_block(tp, pcfg, tx)
    assert torch.equal(py, py0)
    # and JAX's block at the tolerances of test_moe_block_matches_jax
    jy, jaux = JM.moe_block(jax.tree.map(jnp.asarray, params), jcfg,
                            jnp.asarray(x))
    np.testing.assert_allclose(float(paux), float(jaux), rtol=1e-6)
    got, want_y = py.float().numpy(), np.asarray(jy, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want_y, rtol=1e-5, atol=1e-5)
    else:
        assert np.abs(got - want_y).max() <= 2.0 ** -6 * np.abs(want_y).max()


def _setup(jcfg, rank=4, batch=2, seq=16):
    rng = np.random.default_rng(11)
    params = jax.tree.map(np.asarray,
                          JT.init_params(jcfg, jax.random.PRNGKey(0),
                                         jnp.float32))
    lora = jax.tree.map(
        lambda a: (0.05 * rng.standard_normal(a.shape)).astype(np.float32),
        JT.init_lora(jcfg, jax.random.PRNGKey(1), rank=rank))
    tokens = rng.integers(0, jcfg.vocab, (batch, seq)).astype(np.int32)
    labels = rng.integers(0, jcfg.vocab, (batch, seq)).astype(np.int32)
    labels[1, 2] = -1
    return params, lora, {"tokens": tokens, "labels": labels}


def _grads(pcfg, params, lora, batch):
    return PT.loss_and_lora_grads(pcfg, interop.from_numpy_tree(params),
                                  interop.from_numpy_tree(lora), batch)


def test_loss_and_lora_grads_match_jax_reference(test_spec):
    jcfg, pcfg = _cfgs(test_spec)
    params, lora, batch = _setup(jcfg)
    (jt, jm), jg = jax.value_and_grad(
        lambda lo: JT.loss_fn(jcfg, jax.tree.map(jnp.asarray, params), lo,
                              jax.tree.map(jnp.asarray, batch)),
        has_aux=True)(jax.tree.map(jnp.asarray, lora))
    pt, pm, pg = _grads(pcfg, params, lora, batch)
    assert float(pm["aux"]) > 0.0                 # the router loss is in
    for g, w in [(pt, jt)] + [(pm[k], jm[k]) for k in ("loss", "aux", "acc")]:
        np.testing.assert_allclose(float(g), float(w), rtol=1e-4, atol=1e-4)
    paths = interop.tree_paths(pg)
    assert [p for p, _ in paths] == [
        tuple(k.key for k in path)
        for path, _ in jax.tree_util.tree_flatten_with_path(jg)[0]]
    for (_, g), w in zip(paths, jax.tree.leaves(jg)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


def test_forced_kernel_branch_equals_plain_path(test_spec, monkeypatch):
    _, pcfg = _cfgs(test_spec)
    jcfg, _ = _cfgs(test_spec)
    params, lora, batch = _setup(jcfg)
    plain = _grads(pcfg, params, lora, batch)
    calls = []
    real = PM.ops.moe_expert_ffn

    def spy(*a, **kw):
        calls.append(kw["backend"])
        assert kw["fill"].dtype == torch.int32      # the block's fill
        return real(*a, **kw)
    monkeypatch.setattr(PM.ops, "moe_expert_ffn", spy)
    # only the MoE block's branch: attention and the projections keep
    # their plain paths, so the two runs differ in nothing else
    monkeypatch.setattr(PM, "dispatch",
                        types.SimpleNamespace(use_kernel=lambda *a: True))
    pcfg_k = dataclasses.replace(pcfg, kernel_backend="auto")
    forced = _grads(pcfg_k, params, lora, batch)
    assert calls == ["auto"] * pcfg.n_layers
    assert torch.equal(forced[0], plain[0])
    for g, w in zip(interop.tree_leaves(forced[2]),
                    interop.tree_leaves(plain[2])):
        assert torch.equal(g, w)


def test_moe_decode_is_not_ported(test_spec):
    """The MoE decode path runs: stacked expert weights, an attention
    cache per layer, finite logits, and the cursor advanced. (The name
    is the one this test had while MoE decoding still raised.)"""
    _, pcfg = _cfgs(test_spec)
    gen = torch.Generator().manual_seed(0)
    params = PT.init_params(pcfg, gen)
    assert params["blocks"]["layers"]["ffn"]["wg"].shape == (
        pcfg.n_layers, pcfg.moe.n_experts, pcfg.d_model,
        pcfg.moe.d_ff_expert)
    cache = PT.init_cache(pcfg, 3, 8, device="cpu")
    assert sorted(cache["stacks"]["layers"]["mixer"]) == ["k", "v"]
    logits, new = PT.decode_step(pcfg, params, None,
                                 torch.tensor([[1], [2], [3]]), cache)
    assert tuple(logits.shape) == (3, 1, pcfg.padded_vocab)
    assert bool(torch.isfinite(logits[..., :pcfg.vocab]).all())
    assert new["pos"].tolist() == [1, 1, 1]
    assert cache["stacks"]["layers"]["mixer"]["k"][:, :, 0].any()
