"""The port's five baseline methods (FedSA, FLoRA, ProgFed, DoFIT, C2A)
against the JAX package's, hook by hook, on shared trees: the JAX
package's bench-tiny params and LoRA (and, for the two-stack case, a
tree of numpy arrays made from a seed), crossed through
``repro_torch.interop``.

* Registry names, byte counts, capacities and plans: exactly equal.
* Slicing, zeroing and prefix transfer move values without arithmetic:
  bit-equal.
* DoFIT's SVD init, in f32: each A column equal to JAX's up to its sign
  (a singular vector is defined up to sign, and LAPACK builds may pick
  either), every element within 1e-4 of its value plus 1e-4 of the
  column's largest |value|, and |A_col|^2 equal to the singular value
  at rtol 1e-4; B exactly zero. Two f32 SVDs of the same matrix by
  different LAPACK builds differ by f32 rounding of the largest singular
  value over the gap to the neighbouring one: measured at bench-tiny
  (d 128, r 8), at most 4.3e-5 of the column's largest |value|.
The whole-run trajectories are in ``tests/test_torch_runner_methods.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.experiments import get_preset as jax_get_preset
from repro.federated import methods as jmethods
from repro.federated.methods import progfed as jprogfed
from repro.federated.methods.base import LocalSpec as JaxLocalSpec
from repro.federated.methods.dofit import svd_init_lora as jax_svd_init
from repro.models import transformer as JT
from repro_torch import interop
from repro_torch.experiments import get_preset
from repro_torch.federated import methods as pmethods
from repro_torch.federated.methods import progfed as pprogfed
from repro_torch.federated.methods.base import LocalSpec
from repro_torch.federated.methods.dofit import svd_init_lora

torch.set_num_threads(1)

FIVE = ("fedsa", "flora", "progfed", "dofit", "c2a")


@pytest.fixture(scope="module")
def trees():
    """(JAX spec, port spec, JAX params, JAX lora, port params, port
    lora) of bench-tiny, with a nonzero B."""
    jspec = jax_get_preset("bench-tiny")
    pspec = get_preset("bench-tiny")
    cfg = jspec.build_cfg()
    key = jax.random.PRNGKey(0)
    params = JT.init_params(cfg, key, jnp.float32)
    lora = JT.init_lora(cfg, jax.random.fold_in(key, 1),
                        rank=jspec.lora_rank)
    lora = jax.tree_util.tree_map_with_path(
        lambda p, l: (l + 0.01 * jax.random.normal(
            jax.random.PRNGKey(len(str(p))), l.shape))
        if p[-1].key == "b" else l, lora)
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return (jspec, pspec, params, lora,
            interop.from_numpy_tree(to_np(params)),
            interop.from_numpy_tree(to_np(lora)))


def _strategies(name, jspec, pspec):
    return (jmethods.make_strategy(name, jspec.build_cfg(),
                                   jspec.fed_config()),
            pmethods.make_strategy(name, pspec.build_cfg(),
                                   pspec.fed_config()))


def _equal_trees(got, want):
    gp, wp = interop.tree_paths(got), \
        jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in gp] == [tuple(k.key for k in p) for p, _ in wp]
    for (path, g), (_, w) in zip(gp, wp):
        w = np.asarray(w)
        assert g.shape == w.shape, path
        np.testing.assert_array_equal(g.numpy(), w, err_msg=str(path))


def test_registry_holds_the_seven_methods():
    assert pmethods.available_methods() == jmethods.available_methods()
    assert len(pmethods.available_methods()) == 7
    for name in FIVE:
        p, j = pmethods.get_strategy(name), jmethods.get_strategy(name)
        assert (p.aggregation, p.composable, p.description) \
            == (j.aggregation, j.composable, j.description), name
        assert (p.contract.uplink, p.contract.notes) \
            == (j.contract.uplink, j.contract.notes), name
    assert issubclass(pmethods.get_strategy("progfed"),
                      pmethods.StagedStrategy)


@pytest.mark.parametrize("name", FIVE)
def test_payload_bytes_match_jax(trees, name):
    jspec, pspec, jp, jl, pp, pl = trees
    js, ps = _strategies(name, jspec, pspec)
    jls, pls = JaxLocalSpec(jspec.build_cfg(), jp, jl), \
        LocalSpec(pspec.build_cfg(), pp, pl)
    up, down = ps.uplink_payload_bytes(pls), ps.downlink_payload_bytes(pls)
    assert (up, down) == (js.uplink_payload_bytes(jls),
                          js.downlink_payload_bytes(jls))
    assert isinstance(up, int) and isinstance(down, int)
    if name == "fedsa":          # A only: half the tree at d_in == d_out
        assert up < down
    assert ps.downlink_bytes(pl, 3) == js.downlink_bytes(jl, 3)


def test_c2a_post_round_zeros_b_and_keeps_a(trees):
    jspec, pspec, jp, jl, pp, pl = trees
    js, ps = _strategies("c2a", jspec, pspec)
    before = interop.tree_map(torch.clone, pl)
    state = ps.init_state(pp, pl)
    out = ps.post_round(state, pl)
    assert state["lora"] is out
    want = js.post_round(js.init_state(jp, jl), jl)
    _equal_trees(out, want)
    incoming = dict(interop.tree_paths(pl))
    for path, leaf in interop.tree_paths(out):
        if path[-1] == "b":
            assert not bool(leaf.any()), path
            assert leaf is not incoming[path]
        else:
            assert torch.equal(leaf, incoming[path]), path
    # fresh zeros: the incoming tree (which may alias a client's
    # update) is untouched
    for (_, a), (_, b) in zip(interop.tree_paths(pl),
                              interop.tree_paths(before)):
        assert torch.equal(a, b)


def _two_stack_params(seed=5):
    """{"blocks": {"dense": 3 layers, "moe": 9 layers}} of numpy leaves:
    enough for the prefix machinery, which only slices."""
    rng = np.random.default_rng(seed)
    blocks = {name: {"ln1": rng.standard_normal((n, 4), dtype=np.float32),
                     "mixer": {"wq": rng.standard_normal(
                         (n, 4, 6), dtype=np.float32)}}
              for name, n in (("dense", 3), ("moe", 9))}
    lora = {name: {"wq": {"a": rng.standard_normal((n, 4, 2),
                                                   dtype=np.float32),
                          "b": rng.standard_normal((n, 2, 6),
                                                   dtype=np.float32)}}
            for name, n in (("dense", 3), ("moe", 9))}
    return {"blocks": blocks, "embed": rng.standard_normal(
        (8, 4), dtype=np.float32)}, lora


@pytest.mark.parametrize("capacity", [1, 2, 4, 7, 12])
def test_progfed_prefix_submodel_matches_jax(capacity):
    from repro.configs import get_config as jget
    from repro.configs import reduce_config as jreduce
    from repro_torch.configs import get_config, reduce_config
    jcfg = jreduce(jget("deepseek-v3-671b"))
    pcfg = reduce_config(get_config("deepseek-v3-671b"))
    params_np, lora_np = _two_stack_params()
    pp, pl = interop.from_numpy_tree(params_np), \
        interop.from_numpy_tree(lora_np)
    want = jprogfed.prefix_submodel(jcfg, params_np, lora_np, capacity)
    got = pprogfed.prefix_submodel(pcfg, pp, pl, capacity)
    assert got.plan == want.plan and got.capacity == want.capacity
    assert (got.cfg.n_layers, got.cfg.moe.first_dense_layers) \
        == (want.cfg.n_layers, want.cfg.moe.first_dense_layers)
    # every non-empty stack keeps a layer, so capacity 1 trains two
    assert sum(p["prefix"] for p in got.plan.values()) == max(capacity, 2)
    _equal_trees(got.params["blocks"], want.params["blocks"])
    _equal_trees(got.lora, want.lora)
    assert got.params["embed"] is pp["embed"]
    # the trained prefix goes back into a copy of the global tree
    sub = interop.tree_map(lambda t: t + 1.0, got.lora)
    before = interop.tree_map(torch.clone, pl)
    moved = pprogfed.prefix_transfer(pl, sub)
    _equal_trees(moved, jprogfed.prefix_transfer(
        jax.tree.map(jnp.asarray, lora_np),
        jax.tree.map(jnp.asarray, interop.to_numpy_tree(sub))))
    for (_, a), (_, b) in zip(interop.tree_paths(pl),
                              interop.tree_paths(before)):
        assert torch.equal(a, b)


def test_progfed_stages_leave_the_initial_lora_untouched(trees):
    """The prefix views share memory with the initial global LoRA; a
    stage's rounds (post_round commits) and the next stage's rebuild
    must not write through them, and finalize transfers into a copy."""
    jspec, pspec, jp, jl, pp, pl = trees
    js, ps = _strategies("progfed", jspec, pspec)
    before = interop.tree_map(torch.clone, pl)
    state = ps.init_state(pp, pl)
    jstate = js.init_state(jp, jl)
    rounds = ps.build_rounds(state)
    assert rounds == js.build_rounds(jstate)
    stage_prev = -1
    for stage, cap in rounds:
        if stage != stage_prev:
            ps.on_stage(state, stage)
            js.on_stage(jstate, stage)
            stage_prev = stage
            assert state["sub"].plan == jstate["sub"].plan
            assert state["sub"].capacity == cap
        spec = ps.local_spec(state)
        new = interop.tree_map(lambda t: t * 0.5 + 0.25, spec.lora)
        ps.post_round(state, new)
        jnew = jax.tree.map(lambda t: t * 0.5 + 0.25,
                            js.local_spec(jstate).lora)
        js.post_round(jstate, jnew)
        for (_, a), (_, b) in zip(interop.tree_paths(pl),
                                  interop.tree_paths(before)):
            assert torch.equal(a, b)
    final = ps.finalize(state)
    _equal_trees(final, js.finalize(jstate))
    for (_, a), (_, b) in zip(interop.tree_paths(pl),
                              interop.tree_paths(before)):
        assert torch.equal(a, b)


def _close_per_column(got, want, path):
    """(L, d, r) A factors: |got - want| <= 1e-4 (|want| + the column's
    largest |want|), per (layer, column)."""
    col = np.abs(want).max(axis=1, keepdims=True)
    err = np.abs(got - want) - 1e-4 * (np.abs(want) + col)
    assert (err <= 0).all(), (path, float(err.max()))


def test_dofit_svd_init_matches_jax_up_to_sign(trees):
    jspec, pspec, jp, jl, pp, pl = trees
    got = svd_init_lora(pp, pl)
    want = jax_svd_init(jp, jl)
    gp, wp = interop.tree_paths(got), \
        jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in gp] == [tuple(k.key for k in p) for p, _ in wp]
    for (path, g), (_, w) in zip(gp, wp):
        g, w = g.numpy(), np.asarray(w)
        assert g.dtype == w.dtype == np.float32 and g.shape == w.shape
        # the lora_matmul kernel takes contiguous factors only
        assert dict(interop.tree_paths(got))[path].is_contiguous(), path
        if path[-1] == "b":
            assert not g.any(), path
            continue
        # per (layer, column): flip the port's column to JAX's sign
        sign = np.sign(np.sum(g * w, axis=1, keepdims=True))
        assert (sign != 0).all(), path
        _close_per_column(g * sign, w, path)
        # |A_col|^2 is the singular value (v is a unit vector)
        name, tgt = path[0], path[1]
        wl = pp["blocks"][name]["mixer"][tgt].double()
        s = torch.linalg.svdvals(wl)[:, :g.shape[-1]].numpy()
        np.testing.assert_allclose((g.astype(np.float64) ** 2).sum(1), s,
                                   rtol=1e-4)


def test_dofit_strategy_inits_through_the_hook(trees):
    jspec, pspec, jp, jl, pp, pl = trees
    js, ps = _strategies("dofit", jspec, pspec)
    got = ps.init_lora(pp, pl)
    assert [p for p, _ in interop.tree_paths(got)] \
        == [p for p, _ in interop.tree_paths(pl)]
    for path, leaf in interop.tree_paths(got):
        if path[-1] == "b":
            assert not bool(leaf.any())
    # A·B = 0 at init on both sides; the A factors differ only in sign
    for (path, g), (_, w) in zip(
            interop.tree_paths(got),
            interop.tree_paths(interop.from_numpy_tree(
                jax.tree.map(np.asarray, js.init_lora(jp, jl))))):
        _close_per_column(g.abs().numpy(), w.abs().numpy(), path)


def test_fedsa_and_flora_select_their_aggregators(trees):
    jspec, pspec, jp, jl, pp, pl = trees
    rng = np.random.default_rng(3)
    stacked_np = jax.tree.map(
        lambda l: np.stack([np.asarray(l) + rng.standard_normal(
            l.shape).astype(np.float32) * 0.1 for _ in range(2)]), jl)
    stacked = interop.from_numpy_tree(stacked_np)
    for name in ("fedsa", "flora", "c2a"):
        js, ps = _strategies(name, jspec, pspec)
        pst, jst = ps.init_state(pp, pl), js.init_state(jp, jl)
        new, up = ps.aggregate(pst, LocalSpec(pspec.build_cfg(), pp, pl),
                               stacked, 2)
        jnew, jup = js.aggregate(jst, JaxLocalSpec(jspec.build_cfg(), jp,
                                                   jl),
                                 jax.tree.map(jnp.asarray, stacked_np), 2)
        assert up == int(jup), name
        for (path, g), (_, w) in zip(interop.tree_paths(new),
                                     interop.tree_paths(
                                         interop.from_numpy_tree(
                                             jax.tree.map(np.asarray,
                                                          jnew)))):
            torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6,
                                       msg=f"{name} {path}")
