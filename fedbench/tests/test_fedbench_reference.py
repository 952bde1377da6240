"""The plain reference against the port at toy sizes: one DevFT cycle on
each configuration and FedIT rounds, the program in f32 so that the two
agree to rounding; and the check's verdict on planted faults and on the
float8 control, through the rest of a run (a process of its own,
``conftest.run_cpu``)."""
from __future__ import annotations

import json

import pytest

from fedbench import check
from fedbench.calibrate import control_records
from fedbench.reference.fed import follow
from fedbench.tests.conftest import run_cpu

CELLS = ("granite-moe-1b.devft", "jamba-8l.devft", "granite-moe-1b.fedit")


def _one_job(bench, workload, seed, fault=None, where=None):
    cell_doc = bench.workload(workload)
    cfg_doc = bench.config(cell_doc["config"])
    traffic = bench.traffic(cell_doc["traffic"])
    fed = bench.runner(traffic)
    cell = fed.Cell(cfg_doc, bench.reference(cfg_doc), traffic, seed, "cpu",
                    {})
    cap = fed.Capture(cell, fault=fault, where=where)
    with cap.installed():
        cell.job(round_progress=cap.on_round)
    rec = cap.records()
    ref = follow(cell.reference, cell.model, traffic, cell.params,
                 cell.lora0, cell.corpus, seed, rec)
    return cell, traffic, rec, ref


@pytest.mark.parametrize("workload", CELLS)
def test_reference_follows_the_port(toy_bench, workload):
    _, _, rec, ref = _one_job(toy_bench, workload, 2 ** 31 + 7)
    nums = check.numbers(rec, ref)
    assert nums["loss"] < 1e-5 and nums["eval"] < 1e-5
    assert nums["grad"] < 1e-4 and nums["grad_err"] < 1e-4
    assert nums["update"] < 1e-3
    assert nums["agg"] < 1e-6 and nums["cohort"] == 0
    if workload.endswith("devft"):
        assert nums["groups"] == nums["transfer"] == 0
        assert nums["entry"] < 1e-6
        stages = {r["stage"] for r in ref["rounds"]}
        assert stages == {0, 1, 2, 3}


def test_reference_regroups_from_its_own_weights(toy_bench):
    """The groups the reference works out are its own: a changed group
    in the program's records is counted."""
    _, _, rec, ref = _one_job(toy_bench, "granite-moe-1b.devft", 3)
    rnd = next(r for r in rec["rounds"]
               if r["groups"] and len(r["groups"]["layers"]) > 1)
    gs = rnd["groups"]["layers"]
    rnd["groups"] = {"layers": [gs[0] + gs[1][:1], gs[1][1:]] + gs[2:]}
    assert check.numbers(rec, ref)["groups"] == 1


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", [None, "half_batch", "frozen",
                                   "half_clients"])
def test_check_catches_faults(toy_bench, workload, fault):
    """The rest of a run with the chip's look skipped: a sound run is
    correct; a fault planted in the program makes it not correct."""
    rc, lines, errs = run_cpu(toy_bench, [
        "--workload", workload, "--seed", "4294967377", "--seconds", "0.5",
        "--trace", "0"], fault=fault)
    assert rc == 0, errs[-20:]
    result = json.loads(lines[-1])
    assert result["correct"] is (fault is None), result["checks"]


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("lower", [("weights",), ("state",)])
def test_control_is_not_correct(toy_bench, workload, lower):
    """The reference with each stated precision one step down in the
    program's place (float8 weights; bf16 LoRA state) fails one of the
    cell's limits."""
    cell, traffic, rec, ref = _one_job(toy_bench, workload, 5)
    ctl = follow(cell.reference, cell.model, traffic, cell.params,
                 cell.lora0, cell.corpus, 5, rec, lower=lower)
    limits = check.load_limits(toy_bench.here, workload)
    nums = check.numbers(control_records(ctl), ref)
    assert any(nums[k] > limits[k] for k in nums if k in limits), nums


def test_followed_steps_cover_every_step_and_client():
    """Over seeds the check follows both clients, and every local step of
    a round after the first; round 0 always from its first step."""
    from fedbench.data import followed

    seen = set()
    for seed in range(2 ** 31, 2 ** 31 + 40):
        plan = followed(seed, 4, 2, 10, 3)
        assert plan[0][1] == 0
        seen |= {(c, j + k) for c, j in plan[1:] for k in range(3)}
    assert seen == {(c, t) for c in (0, 1) for t in range(10)}


def test_late_fault_in_the_other_client_is_caught(toy_bench):
    """A state left unchanged in the second client's last step, past the
    first three, fails the check on a seed whose followed window covers
    it."""
    from fedbench.data import followed

    workload = "granite-moe-1b.fedit"
    tr = toy_bench.here / "traffic" / "fedit-k10-b16s512.json"
    doc = json.loads(tr.read_text())
    doc["spec"]["k_local"] = 5
    tr.write_text(json.dumps(doc))
    seed = next(s for s in range(1000)
                if (1, 2) in followed(s, 4, 2, 5, 3)[1:2])
    cell, _, rec, ref = _one_job(toy_bench, workload, seed, fault="frozen",
                                 where=lambda c, t: c == 1 and t == 4)
    nums = check.numbers(rec, ref)
    limits = check.load_limits(toy_bench.here, workload)
    assert any(nums[k] > limits[k] for k in nums if k in limits), nums
