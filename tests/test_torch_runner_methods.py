"""The port's five baseline methods through its training entry point
against live runs of the JAX package: bench-tiny (llama2-7b-proxy cut to
4 layers, 6 rounds) under FedSA, FLoRA, ProgFed, DoFIT and C2A, from the
JAX package's pretrained base and initial LoRA (``run_pair`` of
``tests/test_torch_runner.py``), held by its ``check_trajectory``:

* integer ``RoundLog`` fields exactly (round, stage, capacity, the
  uplink and downlink bytes, memory, drops);
* eval loss and accuracy, FLOPs and virtual time at rel = abs = 1e-3;
* the final LoRA at the same limits on at least 99% of each leaf's
  elements, every element within 2·lr·(local steps).

DoFIT is compared on the product A·B per layer instead of the factors:
its SVD init may give a column of A the opposite sign to JAX's (a
singular vector is defined up to sign), Adam carries the flip into the
matching row of B, and A·B and the losses do not see it. Its A·B is
held at rel = abs = 2e-3 on 99% of the elements (every element within
2·lr·steps), not 1e-3: B starts at zero, so A's first gradients are
within rounding of zero and Adam steps many of A's elements by ~lr
either way. Measured at bench-tiny: 2.2% of A·B outside 1e-3 and 0.7%
outside 2e-3 (largest difference 5.5e-3 against a 0.24 ceiling), and
with JAX's own SVD init handed to the port its raw A still has 1.4%
of elements outside 1e-3 — the spread is the method's, not the SVD's.
The losses are held at the usual 1e-3.

Never compared with ``tests/golden/`` (ROADMAP.md, "Faults").
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro_torch import interop
from test_torch_runner import (FLOAT_FIELDS, INT_FIELDS, check_trajectory,
                               run_both)

torch.set_num_threads(1)


def _products(lora):
    """{stack: {target: A·B}} of a LoRA tree (numpy f32, per layer)."""
    return {name: {t: np.einsum("lir,lro->lio", np.asarray(ab["a"]),
                                np.asarray(ab["b"]))
                   for t, ab in stack.items()}
            for name, stack in lora.items()}


@pytest.mark.parametrize("method", ["fedsa", "flora", "c2a"])
def test_bench_tiny_method_matches_jax(method):
    got, want = run_both({"method": method})
    check_trajectory(got, want)
    assert [log.capacity for log in got.logs] == [4] * 6
    up = [log.comm_bytes_up for log in got.logs]
    down = [log.comm_bytes_down for log in got.logs]
    if method == "fedsa":          # A only up, the full tree down
        assert all(2 * u == d for u, d in zip(up, down))
    else:
        assert up == down
    if method == "c2a":            # B reset after every round
        for path, leaf in interop.tree_paths(got.final_lora):
            if path[-1] == "b":
                assert not bool(leaf.any()), path
    assert got.metrics["comm_MB"] == want.metrics["comm_MB"]


def test_bench_tiny_progfed_matches_jax():
    got, want = run_both({"method": "progfed"})
    check_trajectory(got, want)
    caps = [log.capacity for log in got.logs]
    assert caps == [2, 2, 2, 4, 4, 4]
    # prefix submodels: stage 0 ships half the tree
    assert got.logs[0].comm_bytes_up * 2 == got.logs[-1].comm_bytes_up


def test_bench_tiny_dofit_matches_jax():
    got, want = run_both({"method": "dofit"})
    assert len(got.logs) == len(want.logs)
    for g, w in zip(got.logs, want.logs):
        g, w = dataclasses.asdict(g), dataclasses.asdict(w)
        assert all(g[f] == w[f] for f in INT_FIELDS), (g, w)
        for f in FLOAT_FIELDS:
            assert g[f] == pytest.approx(w[f], rel=1e-3, abs=1e-3), (f, g, w)
    assert [log.capacity for log in got.logs] == [4] * 6
    gp = _products(interop.to_numpy_tree(got.final_lora))
    wp = _products(jax.tree.map(np.asarray, want.final_lora))
    steps = got.spec.rounds * got.spec.k_local
    for name, stack in wp.items():
        for t, w in stack.items():
            g = gp[name][t]
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=2 * got.spec.lr * steps)
            off = ~np.isclose(g, w, rtol=2e-3, atol=2e-3)
            assert off.mean() <= 0.01, (name, t, off.mean())
