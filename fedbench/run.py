"""Run one cell of the benchmark once and print its result line.

    python3 fedbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout on a machine with the cards the cell asks
for. ``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1``
its per-layer metrics (the same window, then one cycle under the
profiler). Every run checks what the window's first job produced against
the plain reference and prints each number compared beside its limit:
last on standard error, and under ``checks``, the last key of the result
line, the last line of standard output.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

T_IMPORT = time.time()
ROOT = Path(__file__).resolve().parents[1]
#: top-level module names that must not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def process_start() -> float:
    """The wall time this process started (from /proc), else the time
    this module was imported."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(int(line.split()[1]) for line in f
                        if line.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return T_IMPORT


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, *, device: str = "cuda", bench=None) -> int:
    """One run. ``device`` and ``bench`` let a test drive the rest of a
    run on the CPU with its own benchmark data."""
    t_start = process_start()
    args = parse(argv)
    for path in (ROOT, ROOT / "src"):
        if str(path) not in sys.path:
            sys.path.insert(0, str(path))
    import torch

    from fedbench.bench import Bench
    from fedbench import check

    bench = bench or Bench()
    cell = bench.workload(args.workload)
    if device == "cuda":
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell["chips"]:
            print(f"fedbench: {args.workload} needs {cell['chips']} CUDA "
                  f"card(s); this machine has "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        torch.cuda.set_device(0)
    torch.set_num_threads(min(4, torch.get_num_threads()))
    cfg_doc = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    runner = bench.runner(traffic)
    phases = {"process_start_s": time.time() - t_start}
    t0 = time.perf_counter()
    out = runner.run(cfg_doc, bench.reference(cfg_doc), traffic, args.seed,
                     args.seconds, bool(args.trace), device, phases,
                     bench.kernel_files(), bench.peaks(),
                     check.load_limits(bench.here, args.workload))
    setup_s = phases["process_start_s"] + (out["setup_end"] - t0)
    print("fedbench setup: " + json.dumps(
        {k: round(v, 3) for k, v in phases.items()}), flush=True)
    print("fedbench window: " + json.dumps(
        {"jobs": out["jobs"], "rounds": [[r["stage"], round(r["s"], 4)]
                                         for r in out["window_rounds"]],
         "reference_s": round(out["reference_s"], 2),
         "numbers": out["numbers"]}), flush=True)
    summary = out["ctx"].trace
    if summary:
        path = ROOT / "build" / "fedbench" / \
            f"trace-{args.workload}-{args.seed}.json"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(summary))
        print("fedbench trace: " + json.dumps(
            {"label_s": summary["label_s"], "calls": {
                k: len(v) for k, v in out["ctx"].calls.items()},
             "n_device_ops": summary["n_device_ops"],
             "read_s": round(out["ctx"].trace_read_s, 2),
             "spans_s": {k: round(sum(v), 4) for k, v in
                         summary["spans_s"].items()}}), flush=True)

    metrics = {}
    if args.trace:
        for m in bench.metrics_for(args.workload, "per_layer"):
            v = bench.reader(m["name"])(out["ctx"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = dict(out["e2e"], setup_s=setup_s)
        for m in bench.metrics_for(args.workload, "end_to_end"):
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": torch.cuda.get_device_name(0) if device == "cuda"
           else "cpu", "count": cell["chips"],
           "memory_peak_bytes": int(out["peak_bytes"])}
    result = {"correct": out["correct"], "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": dev}
    if args.trace and summary:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"][:10],
                               "idle_gaps": summary["idle_gaps"][:10]}
    result["checks"] = out["checks"]

    bad = forbidden_modules()
    if bad:
        print(f"fedbench: modules {bad} are loaded in the run's process",
              file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
