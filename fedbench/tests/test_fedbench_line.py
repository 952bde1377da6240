"""The result line's keys, and the cell's data found as files: a
configuration, a traffic mix and a per-layer metric added in a temporary
copy give a new cell with no edit to a file that was there. Each run is a
process of its own (``conftest.run_cpu``)."""
from __future__ import annotations

import json

import pytest

from fedbench.bench import Bench
from fedbench.tests.conftest import run_cpu, toy_copy


def _main(bench, workload, trace):
    return run_cpu(bench, ["--workload", workload, "--seed", "99",
                           "--seconds", "0.2", "--trace", str(trace)])


@pytest.mark.parametrize("trace", [0, 1])
def test_last_line_keys(toy_bench, trace):
    rc, lines, errs = _main(toy_bench, "jamba-8l.devft", trace)
    assert rc == 0, errs[-20:]
    result = json.loads(lines[-1])
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics",
                                "device"]
    assert list(result)[-1] == "checks"
    assert set(result["device"]) >= {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    want = {m["name"] for m in toy_bench.metrics_for(
        "jamba-8l.devft", "per_layer" if trace else "end_to_end")}
    assert set(result["metrics"]) <= want
    if trace:
        # the program's spans and counters reach the readers on the CPU too
        assert {"mfu", "stage_entry_ms", "step_launches", "round_syncs",
                "moe_dropped_pct"} <= set(result["metrics"])
    else:
        assert set(result["metrics"]) == want
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"}
    # every number compared, beside its limit: last on standard error
    names = list(result["checks"])
    assert [e.split(":")[0] for e in errs[-len(names):]] == \
        [f"check {n}" for n in names]


def test_a_cell_added_as_files(tmp_path):
    doc = json.loads((Bench().here.parent / "BENCHMARK.json").read_text())
    bj = toy_copy(tmp_path / "fb", bench_json=doc)
    here = tmp_path / "fb"
    before = {p: p.read_bytes() for p in here.rglob("*") if p.is_file()}
    cfg = json.loads((here / "configs" / "granite-moe-1b-a400m.json")
                     .read_text())
    cfg["model"]["n_layers"] = 2
    (here / "configs" / "granite-2l.json").write_text(json.dumps(cfg))
    tr = json.loads((here / "traffic" / "fedit-k10-b16s512.json").read_text())
    tr["spec"]["rounds"] = 2
    (here / "traffic" / "fedit-2r.json").write_text(json.dumps(tr))
    (here / "metrics" / "rounds_done.py").write_text(
        "def read(ctx):\n    return float(ctx.window_s > 0)\n")
    doc["workloads"].append({"name": "granite-2l.fedit2", "config":
                             "granite-2l", "traffic": "fedit-2r", "chips": 1,
                             "why": "a cell added as files"})
    doc["per_layer"].append({"name": "rounds_done", "unit": "1", "better":
                             "higher", "source": "host_clock", "layer":
                             "round engine", "moves": "train_tokens_per_s",
                             "workloads": ["granite-2l.fedit2"]})
    bj.write_text(json.dumps(doc))
    bench = Bench(here=here, bench_json=bj)
    rc, lines, errs = _main(bench, "granite-2l.fedit2", 1)
    assert rc == 0, errs[-20:]
    result = json.loads(lines[-1])
    assert result["metrics"]["rounds_done"]["value"] == 1.0
    assert result["attempted"] >= 2
    after = {p: p.read_bytes() for p in before}
    assert after == before


SPAN_METRICS = ("lora_backward_pct", "moe_dispatch_combine_pct",
                "step_launches", "round_syncs")


@pytest.mark.parametrize("metric", SPAN_METRICS)
def test_span_metrics_read_the_program_summary(metric):
    """Each span metric's file gives ``program_trace.readings`` of the
    context's program summary, and None without one."""
    from fedbench.program_trace import readings
    from fedbench.runners.federated import Context

    prog = {"program_s": {"kernel.lora_matmul.backward": 0.5,
                          "moe.route": 0.25, "moe.combine": 0.5},
            "program_bwd_s": {"moe.dispatch": 0.25},
            "program_launches": {"client.step": 300},
            "program_syncs": {"round.eval": 2, "client.step": 4},
            "program_calls": {"client.step": 3, "round.local": 2}}
    read = Bench().reader(metric)
    want = {"lora_backward_pct": 25.0, "moe_dispatch_combine_pct": 50.0,
            "step_launches": 100.0, "round_syncs": 3.0}[metric]
    assert read(Context(program=prog, trace={"busy_s": 2.0})) == want \
        == readings(prog, 2.0)[metric]
    assert read(Context(program={}, trace={})) is None
