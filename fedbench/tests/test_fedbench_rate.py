"""The stage-weighted rate on synthetic round records."""
from __future__ import annotations

import math

from fedbench.runners.federated import stage_weighted_rate

PLAN = [(0, 3), (1, 6), (2, 12), (3, 24)]
COST = {0: 1.0, 1: 2.0, 2: 4.0, 3: 8.0}       # seconds a round, by stage


def _rounds(n):
    return [{"stage": PLAN[i % 4][0], "s": COST[PLAN[i % 4][0]]}
            for i in range(n)]


def test_one_cycle_is_all_tokens_over_all_time():
    assert stage_weighted_rate(_rounds(4), PLAN, 100.0) == 400.0 / 15.0


def test_one_more_round_does_not_jump_the_rate():
    """Ending a boundary later, past one more cheap or dear round, leaves
    the rate where it was when every round of a stage costs the same."""
    base = stage_weighted_rate(_rounds(4), PLAN, 100.0)
    for n in range(5, 12):
        assert math.isclose(stage_weighted_rate(_rounds(n), PLAN, 100.0), base)


def test_a_stall_counts_in_full():
    rounds = _rounds(8)
    rounds[5]["s"] += 3.0                      # stage 1, second cycle
    got = stage_weighted_rate(rounds, PLAN, 100.0)
    assert math.isclose(got, 400.0 / (15.0 + 1.5))


def test_single_stage_is_tokens_over_time():
    plan = [(0, 24)] * 4
    rounds = [{"stage": 0, "s": s} for s in (2.0, 3.0, 4.0, 5.0, 6.0)]
    assert math.isclose(stage_weighted_rate(rounds, plan, 10.0),
                        50.0 / 20.0)


def test_a_stage_without_a_round_gives_no_rate():
    assert math.isnan(stage_weighted_rate(_rounds(3), PLAN, 100.0))
