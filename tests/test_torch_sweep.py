"""The port's ``experiments.sweep`` against the JAX package's: grid and
case expansion (cartesian axes, explicit cases, replicate seeds derived
by ``SeedSequence``, an explicit seed axis) gives the same specs (equal
``to_dict`` and ``spec_hash``), ``aggregate_seeds`` folds the same
results to the same numbers, and ``sweep_cases`` runs its cases in order
on the device it is given. Pure Python on both sides: everything is
compared exactly.
"""
import importlib

import pytest
import torch

from repro.experiments import get_preset as jax_get_preset
from repro.experiments.results import RunResult as JaxRunResult
from repro_torch.experiments import (RunResult, aggregate_seeds, expand_cases,
                                     expand_specs, get_preset, sweep_cases)

# the packages export a ``sweep`` function under the module's name
jsweep = importlib.import_module("repro.experiments.sweep")
psweep = importlib.import_module("repro_torch.experiments.sweep")

torch.set_num_threads(1)

AXES = [None, {}, {"method": ["devft", "fedit"]},
        {"method": ["fedsa", "flora"], "aggregation": [None, "fedavg"],
         "rounds": [2, 3]}]


@pytest.mark.parametrize("axes", AXES, ids=["none", "empty", "one", "three"])
def test_expand_cases_matches_jax(axes):
    assert expand_cases(axes) == jsweep.expand_cases(axes)


def _same_specs(got, want):
    assert [s.to_dict() for s in got] == [s.to_dict() for s in want]
    assert [s.spec_hash() for s in got] == [s.spec_hash() for s in want]


@pytest.mark.parametrize("seeds", [1, 3, [7, 11]], ids=["one", "derived",
                                                        "list"])
@pytest.mark.parametrize("base_seed", [0, 3])
def test_expand_specs_matches_jax(seeds, base_seed):
    axes = {"method": ["devft", "progfed"], "lora_rank": [4, 8]}
    jbase = jax_get_preset("bench-tiny").replace(seed=base_seed)
    pbase = get_preset("bench-tiny").replace(seed=base_seed)
    got = expand_specs(pbase, axes, seeds=seeds)
    _same_specs(got, jsweep.expand_specs(jbase, axes, seeds=seeds))
    n = seeds if isinstance(seeds, int) else len(seeds)
    assert len(got) == 4 * n
    if seeds == 3:
        # the spec's own seed first, then SeedSequence-derived ones that
        # do not collide across bases (base + i would)
        assert [s.seed for s in got[:3]][0] == base_seed
        assert len({s.seed for s in got}) == 3


def test_expand_specs_seed_axis_and_cases_match_jax():
    jbase, pbase = jax_get_preset("bench-tiny"), get_preset("bench-tiny")
    axes = {"seed": [5, 6], "method": ["c2a"]}
    _same_specs(expand_specs(pbase, axes, seeds=4),
                jsweep.expand_specs(jbase, axes, seeds=4))
    cases = [{"method": "devft", "aggregation": "fedsa"},
             {"method": "fedsa"}, {"method": "dofit", "seed": 9}]
    got = expand_specs(pbase, cases=cases, seeds=2)
    _same_specs(got, jsweep.expand_specs(jbase, cases=cases, seeds=2))
    assert [s.seed for s in got][-1] == 9 and len(got) == 5
    with pytest.raises(ValueError):
        expand_specs(pbase, {"method": ["fedit"]}, cases=cases)


def test_aggregate_seeds_matches_jax():
    axes = {"method": ["fedit", "flora"]}
    jspecs = jsweep.expand_specs(jax_get_preset("bench-tiny"), axes,
                                 seeds=3)
    pspecs = expand_specs(get_preset("bench-tiny"), axes, seeds=3)
    metrics = [{"final_loss": 1.0 + 0.25 * i, "comm_MB": 3 * (i % 2),
                "flops": f"{i}e9", "converged": i % 2 == 0,
                "best_round": i}
               for i in range(len(jspecs))]
    want = jsweep.aggregate_seeds([
        JaxRunResult(spec=s, logs=[], wall_s=0.0, metrics=m)
        for s, m in zip(jspecs, metrics)])
    got = aggregate_seeds([RunResult(spec=s, logs=[], wall_s=0.0, metrics=m)
                           for s, m in zip(pspecs, metrics)])
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g["spec"].spec_hash() == w["spec"].spec_hash()
        assert (g["seeds"], g["n_seeds"], g["metrics"]) \
            == (w["seeds"], w["n_seeds"], w["metrics"])
    assert got[0]["metrics"]["converged"] is True    # bools are not numbers
    assert got[0]["metrics"]["flops"] == "0e9"


def test_sweep_cases_runs_in_order_on_the_given_device():
    base = get_preset("bench-tiny").replace(rounds=1, pretrain_steps=0,
                                            layers=2, seq=8, local_batch=2,
                                            k_local=1)
    cases = [{"method": "c2a"}, {"method": "fedsa"}]
    seen, rounds = [], []
    results = sweep_cases(base, cases, device="cpu",
                          progress=lambda i, n, s: seen.append((i, n,
                                                                s.method)),
                          round_progress=rounds.append)
    assert seen == [(0, 2, "c2a"), (1, 2, "fedsa")]
    assert [r.spec.method for r in results] == ["c2a", "fedsa"]
    assert len(rounds) == 2 and all(len(r.logs) == 1 for r in results)
    # the A-only uplink against the full tree, from the same shapes
    assert results[1].logs[0].comm_bytes_up * 2 \
        == results[0].logs[0].comm_bytes_up
    folded = aggregate_seeds(results)
    assert [f["spec"].method for f in folded] == ["c2a", "fedsa"]
    assert psweep.sweep.__kwdefaults__["device"] == "cuda"
