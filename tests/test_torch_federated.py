"""The PyTorch port's federated training pieces against the JAX package:
the synthetic data pipeline, AdamW and the LR schedules, client local
training (``make_local_train``, with and without a step mask), one
federated round (``make_federated_round_step``, uniform and
heterogeneous), and the server aggregators.

* Data is pure numpy in both packages: batches, permutations and seeds
  must be ``array_equal``.
* AdamW on given gradients: f32 rtol = 1e-6, atol = 1e-7 (the same
  elementwise formula; sqrt and division may round one ulp apart).
* Training trajectories, at the tolerances the JAX package holds its own
  two backends to (``tests/test_kernel_dispatch.py:330``): per-step
  losses at rel = atol = 1e-3; LoRA leaves after K AdamW steps at
  atol = 2 * lr * K, since Adam moves an element by about lr whatever
  the size of its gradient, so a gradient near zero may step either way;
  and the update itself (leaf after minus leaf before) within 1e-3 * lr
  of JAX's on all but 1% of each leaf's elements: the gradients agree to
  ~1e-6 relative in f32, so only an element whose gradient is within
  noise of zero may step otherwise.
* Aggregation: f32 rtol = atol = 1e-6 (means and weighted sums in
  another order); uplink bytes equal integers.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduce_config as jax_reduce_config
from repro.data import synthetic as jsyn
from repro.federated import aggregation as jagg
from repro.federated.client import make_local_train as jax_local_train
from repro.launch import steps as jsteps
from repro.models import transformer as JT
from repro.optim import adamw as jadamw
from repro.optim import schedule as jsched
from repro_torch import interop
from repro_torch.configs import ReducedSpec, get_config, reduce_config
from repro_torch.data import synthetic as psyn
from repro_torch.federated import aggregation as pagg
from repro_torch.federated.client import make_local_train
from repro_torch.launch import steps as psteps
from repro_torch.optim import adamw as padamw
from repro_torch.optim import schedule as psched

torch.set_num_threads(1)

LR = 1e-3
# see the module docstring
UPDATE_ATOL, UPDATE_NOISY = 1e-3 * LR, 0.01


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, (3, "pretrain")], ids=["int", "keyed"])
def test_synthetic_data_is_array_equal(seed):
    jd = jsyn.make_federated_data(97, n_clients=5, alpha=0.3, seed=seed)
    pd = psyn.make_federated_data(97, n_clients=5, alpha=0.3, seed=seed)
    for f in ("global_perm", "client_perms", "mix"):
        np.testing.assert_array_equal(getattr(pd, f), getattr(jd, f))
    assert (pd.vocab, pd.n_clients, pd.noise) == (jd.vocab, jd.n_clients,
                                                  jd.noise)
    for c in range(5):
        want = jd.sample_batch(c, 3, 11, np.random.RandomState(c))
        got = pd.sample_batch(c, 3, 11, np.random.RandomState(c))
        for key in ("tokens", "labels"):
            np.testing.assert_array_equal(got[key], want[key])
            assert got[key].dtype == want[key].dtype == np.int32
    for es in (1234, (7, 2)):
        for key in ("tokens", "labels"):
            np.testing.assert_array_equal(pd.eval_batch(4, 9, es)[key],
                                          jd.eval_batch(4, 9, es)[key])
    want = jsyn.client_round_batches(jd, [4, 0, 2], 3, 2, 8, (seed, 1)
                                     if isinstance(seed, int) else seed)
    got = psyn.client_round_batches(pd, [4, 0, 2], 3, 2, 8, (seed, 1)
                                    if isinstance(seed, int) else seed)
    for key in ("tokens", "labels"):
        assert got[key].shape == (3, 3, 2, 8)
        np.testing.assert_array_equal(got[key], want[key])


def test_seed_helpers_are_equal():
    assert psyn.seed_entropy(5) == jsyn.seed_entropy(5) == (5,)
    assert psyn.seed_entropy((1, 2)) == jsyn.seed_entropy((1, 2))
    assert psyn.derived_seeds(6, 3, "cohort") == jsyn.derived_seeds(
        6, 3, "cohort")
    assert psyn.derived_seeds(0, 1) == []
    for entropy in ((0,), (2, "cohort"), (9, 4, 1)):
        np.testing.assert_array_equal(
            psyn.keyed_rng(*entropy).randint(0, 1 << 30, size=16),
            jsyn.keyed_rng(*entropy).randint(0, 1 << 30, size=16))
    np.testing.assert_array_equal(psyn.client_rng((1, 5), 3).rand(8),
                                  jsyn.client_rng((1, 5), 3).rand(8))


def test_schedules_are_equal():
    for step in range(0, 60, 7):
        assert psched.cosine(step, 50, 3e-4) == jsched.cosine(step, 50, 3e-4)
        assert psched.wsd(step, 50, 1e-3) == jsched.wsd(step, 50, 1e-3)
        assert psched.staged_cosine(2, step, 50) \
            == jsched.staged_cosine(2, step, 50)
    for stage in range(6):
        assert psched.staged_lr(stage) == jsched.staged_lr(stage)


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_adamw_matches_jax(weight_decay):
    rng = np.random.default_rng(11)
    params = {"w": rng.standard_normal((4, 6)).astype(np.float32),
              "z": {"b": rng.standard_normal((3,)).astype(np.float32)}}
    jp, pp = jax.tree.map(jnp.asarray, params), interop.from_numpy_tree(params)
    js, ps = jadamw.init_adamw(jp), padamw.init_adamw(pp)
    for step in range(4):
        grads = jax.tree.map(
            lambda a: (rng.standard_normal(a.shape) * 10.0 ** -step
                       ).astype(np.float32), params)
        jp, js = jadamw.adamw_update(jax.tree.map(jnp.asarray, grads), js,
                                     jp, 1e-2, weight_decay=weight_decay)
        pp, ps = padamw.adamw_update(interop.from_numpy_tree(grads), ps, pp,
                                     1e-2, weight_decay=weight_decay)
    assert int(ps.count) == int(js.count) == 4
    for got, want in ((pp, jp), (ps.mu, js.mu), (ps.nu, js.nu)):
        for g, w in zip(interop.tree_leaves(got), jax.tree.leaves(want)):
            assert g.dtype == torch.float32
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-7)


def test_adamw_keeps_leaf_dtypes_and_inputs():
    p = {"a": torch.ones(3, dtype=torch.bfloat16)}
    st = padamw.init_adamw(p)
    new, st2 = padamw.adamw_update({"a": torch.ones(3)}, st, p, 0.5)
    assert new["a"].dtype == torch.bfloat16 and st2.mu["a"].dtype \
        == torch.float32
    assert bool((p["a"] == 1).all()) and int(st.count) == 0


# ---------------------------------------------------------------------------
# local training and the federated round
# ---------------------------------------------------------------------------


def _model(test_spec, arch="llama2-7b-proxy"):
    jcfg = dataclasses.replace(jax_reduce_config(jax_get_config(arch),
                                                 test_spec), dtype="float32")
    pcfg = dataclasses.replace(
        reduce_config(get_config(arch),
                      ReducedSpec(**dataclasses.asdict(test_spec))),
        dtype="float32")
    rng = np.random.default_rng(5)
    params = jax.tree.map(np.asarray,
                          JT.init_params(jcfg, jax.random.PRNGKey(0)))
    lora = jax.tree.map(
        lambda a: (0.05 * rng.standard_normal(a.shape)).astype(np.float32),
        JT.init_lora(jcfg, jax.random.PRNGKey(1), rank=4))
    data = psyn.make_federated_data(jcfg.vocab, n_clients=4, seed=0)
    return jcfg, pcfg, params, lora, data


def _close_lora(got, want, before, k_steps):
    """LoRA leaves after K AdamW steps against JAX's, from ``before``."""
    for g, w, b in zip(interop.tree_leaves(got), jax.tree.leaves(want),
                       jax.tree.leaves(before)):
        g, w = g.numpy(), np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=0, atol=2 * LR * k_steps)
        # the update itself: an element whose gradient is not within
        # noise of zero moves as JAX's does, to f32 rounding of the leaf
        # (measured <= 6e-8); a skipped step, a flipped sign or an
        # ignored step mask moves nearly every element by ~lr
        off = np.abs((g - b) - (w - b)) > UPDATE_ATOL
        assert off.mean() <= UPDATE_NOISY, (off.mean(), g.shape)


def _close_loss(got, want):
    np.testing.assert_allclose(float(got), float(want), rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("mask", [None, [1.0, 0.0, 1.0]],
                         ids=["unmasked", "masked"])
def test_local_train_matches_jax(mask, test_spec):
    jcfg, pcfg, params, lora, data = _model(test_spec)
    k_steps = 3
    batches = psyn.client_round_batches(data, [1], k_steps, 2, 16, (0, 1))
    batches = {k: v[0] for k, v in batches.items()}
    jfn = jax.jit(jax_local_train(jcfg))
    jmask = None if mask is None else jnp.asarray(mask, jnp.float32)
    jlora, jm = jfn(jax.tree.map(jnp.asarray, params),
                    jax.tree.map(jnp.asarray, lora),
                    jax.tree.map(jnp.asarray, batches), LR, jmask)
    plora_in = interop.from_numpy_tree(lora)
    plora, pm = make_local_train(pcfg)(interop.from_numpy_tree(params),
                                       plora_in, batches, LR,
                                       None if mask is None
                                       else np.asarray(mask, np.float32))
    _close_loss(pm["loss_first"], jm["loss_first"])
    _close_loss(pm["loss_last"], jm["loss_last"])
    assert float(pm["n_examples"]) == float(jm["n_examples"])
    _close_lora(plora, jlora, lora, k_steps)
    # the caller's LoRA is left as it was
    for g, w in zip(interop.tree_leaves(plora_in), jax.tree.leaves(lora)):
        assert np.array_equal(g.numpy(), w)


def test_all_masked_steps_leave_lora_untouched(test_spec):
    _, pcfg, params, lora, data = _model(test_spec)
    batches = psyn.client_round_batches(data, [2], 2, 2, 8, 3)
    batches = {k: v[0] for k, v in batches.items()}
    plora = interop.from_numpy_tree(lora)
    out, m = make_local_train(pcfg)(interop.from_numpy_tree(params), plora,
                                    batches, LR, np.zeros(2, np.float32))
    assert float(m["n_examples"]) == 0.0
    for g, w in zip(interop.tree_leaves(out), interop.tree_leaves(plora)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("hetero", [False, True], ids=["uniform", "hetero"])
def test_federated_round_matches_jax(hetero, test_spec):
    jcfg, pcfg, params, lora, data = _model(test_spec, "qwen2-7b")
    k_steps, clients = 2, [0, 3]
    batches = psyn.client_round_batches(data, clients, k_steps, 2, 8, (0, 2))
    jstep = jax.jit(jsteps.make_federated_round_step(
        jcfg, k_local=k_steps, remat=False, hetero=hetero))
    pstep = psteps.make_federated_round_step(pcfg, k_local=k_steps,
                                             remat=False, hetero=hetero)
    extra = ()
    if hetero:
        masks = np.array([[1, 1], [1, 0]], np.float32)
        weights = np.array([0.7, 0.3], np.float32)
        extra = (masks, weights)
    jlora, jloss = jstep(jax.tree.map(jnp.asarray, params),
                         jax.tree.map(jnp.asarray, lora),
                         jax.tree.map(jnp.asarray, batches), LR,
                         *(jnp.asarray(e) for e in extra))
    plora, ploss = pstep(interop.from_numpy_tree(params),
                         interop.from_numpy_tree(lora), batches, LR, *extra)
    _close_loss(ploss, jloss)
    _close_lora(plora, jlora, lora, k_steps)
    changed = [not np.allclose(g.numpy(), w) for g, w in
               zip(interop.tree_leaves(plora), jax.tree.leaves(lora))]
    assert all(changed)


# ---------------------------------------------------------------------------
# aggregation
# ---------------------------------------------------------------------------


def _trees(n_clients=3, rank=4):
    rng = np.random.default_rng(21)
    glob = {"layers": {t: {"a": rng.standard_normal((2, 8, rank)),
                           "b": rng.standard_normal((2, rank, 6))}
                       for t in ("wq", "wv")}}
    glob = jax.tree.map(lambda a: a.astype(np.float32), glob)
    stacked = jax.tree.map(
        lambda a: (a[None] + rng.standard_normal((n_clients,) + a.shape)
                   ).astype(np.float32), glob)
    return glob, stacked


@pytest.mark.parametrize("weighted", [False, True],
                         ids=["unweighted", "weighted"])
@pytest.mark.parametrize("method", ["fedavg", "fedsa", "flora"])
def test_aggregators_match_jax(method, weighted):
    glob, stacked = _trees()
    kw = {"client_ranks": [4, 2, 1]} if method == "flora" else {}
    weights = np.array([0.5, 0.2, 0.1], np.float32) if weighted else None
    jnew, jup = jagg.aggregate(
        method, jax.tree.map(jnp.asarray, glob),
        jax.tree.map(jnp.asarray, stacked),
        weights=None if weights is None else jnp.asarray(weights), **kw)
    pnew, pup = pagg.aggregate(method, interop.from_numpy_tree(glob),
                               interop.from_numpy_tree(stacked),
                               weights=weights, **kw)
    assert isinstance(pup, int) and pup == jup
    for g, w in zip(interop.tree_leaves(pnew), jax.tree.leaves(jnew)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)


def test_aggregation_registry_mirrors_jax():
    assert pagg.available_aggregations() == jagg.available_aggregations()
    glob, stacked = _trees()
    for alias in ("fedit", "devft", "fedsa-lora"):
        got, _ = pagg.aggregate(alias, interop.from_numpy_tree(glob),
                                interop.from_numpy_tree(stacked))
        want, _ = jagg.aggregate(alias, jax.tree.map(jnp.asarray, glob),
                                 jax.tree.map(jnp.asarray, stacked))
        for g, w in zip(interop.tree_leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-6)
    with pytest.raises(ValueError, match="unknown aggregation"):
        pagg.aggregate("nope", {}, {})
    with pytest.raises(ValueError, match="already registered"):
        pagg.register_aggregator("fedavg", pagg.fedavg)
    assert pagg.default_flora_ranks(32, 6) == jagg.default_flora_ranks(32, 6)

    @dataclasses.dataclass
    class Fed:
        flora_ranks: tuple = ()
        lora_rank: int = 16
    for fed in (Fed(), Fed(flora_ranks=(8, 4, 2))):
        assert pagg.extra_kwargs("flora", fed, 3) \
            == jagg.extra_kwargs("flora", fed, 3)
    assert pagg.extra_kwargs("fedavg", Fed(), 3) == {}
    with pytest.raises(ValueError, match="flora_ranks"):
        pagg.extra_kwargs("flora", Fed(flora_ranks=(8,)), 3)
