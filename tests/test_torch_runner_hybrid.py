"""The PyTorch port's round engine on the deeper Mamba-2 paths — mamba2
and jamba's hybrid order at 8 layers — held to a live run of the JAX
package round by round.

Why round by round. At 8 layers the port's chained ``bench-tiny`` run
leaves the JAX run's trajectory beyond ``check_trajectory``'s rel = abs
= 1e-3 after a round or two (mamba2-2.7b FedIT: 8.3e-4 at round 1,
1.5e-2 at round 4), while each single step agrees to rounding
(``test_mamba2_step_from_jax_state_agrees_to_rounding`` takes one step
apart: every layer's forward, the loss, every LoRA gradient and Adam's
update). The spread is Adam's: its first steps move an element by about
lr whatever the size of its gradient, so an element whose gradient is
within rounding of zero (B's first gradient, where A's is exactly zero)
steps either way, and A's next gradients through that B by up to
2·0.74·lr = 1.5e-2. A few such elements a round put the chained runs on
different trajectories, and depth gives more of them. ROADMAP.md,
queue 3, states this limit.

So the port is held to what it can be held to: each round's step from
the JAX run's own state. ``run_pair_by_round`` runs the JAX experiment
live, recording every round program's inputs (the (sub)model params,
the LoRA, the clients' batches, the learning rate) and its output; the
port's experiment then runs through its own runner (its own stages,
submodels, transfer maps, aggregation and evaluation), but each round
program takes the JAX run's inputs of that round. Compared:

* the port's own round inputs against JAX's: batches and learning rate
  exactly, submodel params at 1e-5, the LoRA within the final-LoRA
  limits below (so the stage machinery — DGLG groups, DBLF fusion and
  the transfer maps — is held at every stage entry);
* every ``RoundLog`` by ``check_trajectory``, unchanged: integer fields
  exactly, floats at rel = abs = 1e-3, the final LoRA at the same
  limits on at least 99% of each leaf's elements and every element
  within 2·lr·(local steps).

Runs: mamba2-2.7b FedIT and jamba-v0.1-52b DevFT at ``layers=8`` (the
JAX package cannot build jamba at 4 layers: its attention stack would be
empty, 4 // 8 = 0, and ``_stack_init`` maps over no trees), the full six
``bench-tiny`` rounds each. Reduced deepseek-v3's DevFT is in
``tests/test_torch_runner_mla.py``.
"""
import jax
import numpy as np
import pytest
import torch

from repro.experiments import get_preset as jax_get_preset
from repro.federated import simulator as JS
from repro_torch import interop
from repro_torch.experiments import get_preset
from repro_torch.federated import simulator as PS
from test_torch_runner import check_trajectory, run_pair

torch.set_num_threads(1)


def _close_lora(got, want, lr, steps):
    """The final-LoRA limits of ``check_trajectory``, leaf by leaf."""
    gl = interop.tree_paths(got)
    wl = interop.tree_paths(interop.from_numpy_tree(want))
    assert [p for p, _ in gl] == [p for p, _ in wl]
    for (path, g), (_, w) in zip(gl, wl):
        g, w = g.numpy(), w.numpy()
        np.testing.assert_allclose(g, w, rtol=0, atol=2 * lr * steps)
        off = ~np.isclose(g, w, rtol=1e-3, atol=1e-3)
        assert off.mean() <= 0.01, (path, off.mean())


def run_pair_by_round(monkeypatch, jspec, pspec):
    """(port RunResult, JAX RunResult, rounds): the JAX run live, the
    port's run with each round program given the JAX run's inputs of
    that round; ``rounds`` pairs the port's own inputs with JAX's."""
    recorded, seen = [], []
    jax_round_fn = JS.FederatedRunner._round_fn

    def recording(self, spec):
        fn, aux = jax_round_fn(self, spec)

        def round_fn(params, lora, batches, lr, *rest):
            out = fn(params, lora, batches, lr, *rest)
            recorded.append(jax.tree.map(np.asarray, (params, lora, batches,
                                                      lr)))
            return out
        return round_fn, aux

    port_program = PS.make_round_program

    def replaying(strategy, run_state, sub_cfg, n_sample, mesh=None):
        fn, aux = port_program(strategy, run_state, sub_cfg, n_sample, mesh)

        def round_fn(params, lora, batches, lr, *rest):
            jparams, jlora, jbatches, jlr = recorded[len(seen)]
            seen.append(((params, lora, batches, lr),
                         (jparams, jlora, jbatches, jlr)))
            to_port = interop.from_numpy_tree
            return fn(to_port(jparams), to_port(jlora), to_port(jbatches),
                      float(jlr), *rest)
        return round_fn, aux

    monkeypatch.setattr(JS.FederatedRunner, "_round_fn", recording)
    monkeypatch.setattr(PS, "make_round_program", replaying)
    got, want = run_pair(jspec, pspec)
    assert len(seen) == len(recorded) == len(want.logs)
    return got, want, seen


def check_by_round(got, want, rounds):
    spec = got.spec
    for (params, lora, batches, lr), (jparams, jlora, jbatches, jlr) \
            in rounds:
        for k, v in batches.items():
            assert np.array_equal(v.numpy(), jbatches[k]), k
        assert np.float32(lr) == jlr
        for (path, g), (_, w) in zip(
                interop.tree_paths(params),
                interop.tree_paths(interop.from_numpy_tree(jparams))):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                       atol=1e-5, err_msg=str(path))
        _close_lora(lora, jlora, spec.lr, spec.rounds * spec.k_local)
    check_trajectory(got, want)


def _specs(**kw):
    return (jax_get_preset("bench-tiny").replace(**kw),
            get_preset("bench-tiny").replace(**kw))


@pytest.fixture(scope="module")
def mamba_fedit():
    with pytest.MonkeyPatch.context() as mp:
        return run_pair_by_round(
            mp, *_specs(arch="mamba2-2.7b", method="fedit", layers=8))


def test_mamba2_fedit_each_round_from_jax_state(mamba_fedit):
    got, want, rounds = mamba_fedit
    check_by_round(got, want, rounds)
    assert [log.capacity for log in got.logs] == [8] * 6


def test_mamba2_step_from_jax_state_agrees_to_rounding(mamba_fedit):
    """Where the chained runs part: one local step of client 0 from the
    JAX run's own state, tensor by tensor (round 1: its LoRA, a fresh
    Adam state, its batch). Every layer's forward from the same input,
    the loss, each LoRA gradient and Adam's update agree to rounding.
    Then round 0's two steps: A's first gradient is exactly zero in both
    (B starts at zero), and wherever the first gradient of B has a
    different sign in the two packages it is within rounding of zero —
    Adam still moves that element by about lr either way."""
    from repro.models import transformer as JT
    from repro.optim.adamw import adamw_update as jax_adamw
    from repro.optim.adamw import init_adamw as jax_init_adamw
    from repro_torch.models import transformer as PT
    from repro_torch.optim.adamw import adamw_update, init_adamw
    got, _, rounds = mamba_fedit
    jcfg = _specs(arch="mamba2-2.7b", layers=8)[0].build_cfg()
    pcfg = got.spec.build_cfg()
    to_port = interop.from_numpy_tree

    def step(r, t):
        jparams, jlora, jbatches, _ = rounds[r][1]
        batch = {k: v[0, t] for k, v in jbatches.items()}
        jgrad = jax.grad(lambda lo: JT.loss_fn(jcfg, jparams, lo, batch)[0])
        return jparams, jlora, batch, jgrad

    jparams, jlora, batch, jgrad = step(1, 0)
    x, _, _, _ = JT._embed_inputs(jcfg, jparams, batch)
    worst = 0.0
    for i in range(8):
        p = jax.tree.map(lambda a: a[i], jparams["blocks"]["layers"])
        lo = jax.tree.map(lambda a: a[i], jlora["layers"])
        want, _ = JT.block_forward(p, jcfg, "mamba_only", x, None, None, lo)
        got_, _ = PT.block_forward(to_port(p), pcfg, "mamba_only",
                                   torch.from_numpy(np.array(x)), None, None,
                                   to_port(lo))
        want = np.asarray(want)
        worst = max(worst, float(np.abs(got_.numpy() - want).max()
                                 / np.abs(want).max()))
        x = want
    jg = jax.tree.map(np.asarray, jgrad(jlora))
    _, _, pg = PT.loss_and_lora_grads(pcfg, to_port(jparams), to_port(jlora),
                                      batch)
    grad_rel = max(float(np.abs(g.numpy() - w).max() / np.abs(w).max())
                   for (_, g), w in zip(interop.tree_paths(pg),
                                        jax.tree.leaves(jg)))
    lr = float(rounds[1][1][3])
    want, _ = jax_adamw(jg, jax_init_adamw(jlora), jlora, lr)
    new, _ = adamw_update(to_port(jg), init_adamw(to_port(jlora)),
                          to_port(jlora), lr)
    adam = max(float(np.abs(g.numpy() - np.asarray(w)).max())
               for (_, g), w in zip(interop.tree_paths(new),
                                    jax.tree.leaves(want)))
    print(f"round 1, client 0, one step: forward {worst:.2e} of each "
          f"layer's largest output, gradients {grad_rel:.2e} of each "
          f"leaf's largest, Adam {adam:.2e}")
    assert worst <= 1e-5 and grad_rel <= 1e-5 and adam <= 1e-7

    _, jlora0, batch0, jgrad0 = step(0, 0)
    jg0 = jax.tree.map(np.asarray, jgrad0(jlora0))
    _, _, pg0 = PT.loss_and_lora_grads(pcfg, to_port(jparams), to_port(jlora0),
                                       batch0)
    flips = 0
    for (path, g), w in zip(interop.tree_paths(pg0), jax.tree.leaves(jg0)):
        g = g.numpy()
        if path[-1] == "a":
            assert not g.any() and not w.any(), path
            continue
        differ = np.sign(g) != np.sign(w)
        flips += int(differ.sum())
        assert np.abs(w[differ]).max(initial=0) <= 1e-6 * np.abs(w).max()
    print(f"round 0, client 0, first step: {flips} elements of B's "
          f"gradient with different signs, all within 1e-6 of the leaf's "
          f"largest")


def test_jamba_devft_each_round_from_jax_state(monkeypatch):
    got, want, rounds = run_pair_by_round(
        monkeypatch, *_specs(arch="jamba-v0.1-52b", method="devft",
                             layers=8))
    check_by_round(got, want, rounds)
    assert [log.capacity for log in got.logs] == [4, 4, 4, 8, 8, 8]
