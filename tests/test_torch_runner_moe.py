"""The PyTorch port's training entry point on the MoE arch and on a
heterogeneous fleet, against a live run of the JAX package (the helpers
and limits of ``tests/test_torch_runner.py``):

* ``bench-tiny`` DevFT on granite-moe-1b-a400m (reduced: 4 experts,
  top 2; 4 layers, capacities 2 -> 4): the same ``RoundLog`` trajectory
  and final LoRA as JAX, from JAX's pretrained base;
* ``hetero-edge`` (the pareto-edge fleet, partial work accepted at the
  deadline, example-weighted FedAvg) at 6 rounds: the same round plans
  — clients, step masks, drops, weights, durations — from both
  packages' ``plan_round``, and the same trajectory through the masked,
  weighted round (in which clients are dropped, one runs one of its two
  local steps and one runs both).
"""
import numpy as np

from repro.federated import heterogeneity as JH
from repro_torch.federated import heterogeneity as PH
from test_torch_runner import check_trajectory, run_both


def test_bench_tiny_granite_moe_devft_matches_jax():
    got, want = run_both({"arch": "granite-moe-1b-a400m", "method": "devft"})
    check_trajectory(got, want)
    assert [log.capacity for log in got.logs] == [2, 2, 2, 4, 4, 4]


def test_hetero_edge_plans_are_equal():
    for fleet in PH.available_fleets():
        pp, jp = PH.make_population(fleet, 8, 3), JH.make_population(fleet,
                                                                     8, 3)
        assert pp.profiles == tuple(PH.DeviceProfile(**p.__dict__)
                                    for p in jp.profiles)
        assert pp.is_reference == jp.is_reference
    assert PH.available_fleets() == JH.available_fleets()
    pop_p, pop_j = PH.make_population("pareto-edge", 8, 0), \
        JH.make_population("pareto-edge", 8, 0)
    drops = 0
    for rnd in range(6):
        clients = np.random.default_rng(rnd).choice(8, 2, replace=False)
        for policy in PH.POLICIES:
            for weighting in PH.WEIGHTINGS:
                kw = dict(k_local=4, step_flops=3e9, up_bytes=40_000,
                          down_bytes=40_000, policy=policy,
                          weighting=weighting, deadline_factor=1.5,
                          batch=4, seq=32)
                got = PH.plan_round(pop_p, clients, rnd, **kw)
                want = JH.plan_round(pop_j, clients, rnd, **kw)
                assert got.clients == want.clients
                for f in ("k_steps", "kept", "weights", "step_mask"):
                    np.testing.assert_array_equal(getattr(got, f),
                                                  getattr(want, f))
                assert (got.duration_s, got.deadline_s) \
                    == (want.duration_s, want.deadline_s)
                drops += got.n_dropped
    assert drops > 0                      # the fleet really drops clients


def test_hetero_edge_trajectory_matches_jax():
    got, want = run_both({"rounds": 6, "layers": 4}, preset="hetero-edge")
    check_trajectory(got, want)
    assert [log.capacity for log in got.logs] == [1, 1, 2, 2, 4, 4]
    # drops in every round; partial work in round 3, full work in round 4
    assert [log.n_dropped for log in got.logs] == [2, 2, 2, 1, 1, 2]
    flops = [log.flops for log in got.logs]
    assert flops[:3] == [0.0] * 3 and flops[5] == 0.0
    assert 0 < flops[3] < flops[4]
