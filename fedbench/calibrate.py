"""The readings the check's limits are set from, at a cell's own sizes:
for each seed one job of the program, recorded as the window records its
first job, held against the f32 reference; with ``--controls`` also
each control, the reference put in the program's place with one stated
precision one step down (``weights``: float8 e4m3 frozen weights;
``state``: bf16 LoRA state); with ``--fault`` a
fault planted in the program instead (``half_batch``, ``frozen`` or
``half_clients``). One JSON line a seed and side. ``--limits`` reads
such lines back and writes the cell's limits file from them
(``set_limits``).

    python3 fedbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--controls weights,state] [--fault half_batch] [--out x.jsonl]
    python3 fedbench/calibrate.py --workload <cell> --limits x.jsonl ...
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
#: numbers compared exactly (limit 0)
EXACT = ("entry", "cohort", "groups", "transfer")
#: how far over the sound runs' largest reading a control (a fault) has
#: to read to set a number's upper reading
CONTROL_X, FAULT_X = 3.0, 10.0


def control_records(ctl: dict) -> dict:
    """The control's records as the program's: its followed steps and its
    eval of the program's aggregate."""
    keep = ("losses", "g1", "start", "after", "eval")
    return {"rounds": [{k: r[k] for k in keep} for r in ctl["rounds"]]}


def _sig(x: float, digits: int = 2) -> float:
    return float(f"{x:.{digits - 1}e}")


def set_limits(lines) -> dict:
    """A cell's limits from calibration lines: for each number the lower
    reading (the largest over the program's seeds), the upper one (the
    least over its seeds of the control or fault side that reads at
    least ``CONTROL_X`` or ``FAULT_X`` times the lower, the least of
    those sides), and the limit ``lower^(1/3) upper^(2/3)``, nearer the
    upper (fresh seeds read higher than the calibration's). A number with
    no upper is not compared, unless it is exact and read 0 every time;
    one the check no longer computes (``fedbench.check.NAMES``) is
    skipped."""
    from fedbench.check import NAMES

    prog = [ln["numbers"] for ln in lines if ln["side"] == "program"]
    sides = {}
    for ln in lines:
        if ln["side"] != "program":
            sides.setdefault(ln["side"], []).append(ln["numbers"])
    out = {}
    for name in [k for k in NAMES if any(k in n for n in prog)]:
        read = [n[name] for n in prog if name in n]
        lower = max(read)
        if name in EXACT:
            if lower == 0:
                out[name] = {"limit": 0, "exact": True, "lower": 0.0,
                             "seeds": len(read)}
            continue
        ups = {}
        for side, nums in sides.items():
            vals = [n[name] for n in nums if name in n]
            x = CONTROL_X if side.startswith("control") else FAULT_X
            if vals and min(vals) >= x * lower:
                ups[side] = min(vals)
        if not ups:
            continue
        side = min(ups, key=ups.get)
        upper = ups[side]
        out[name] = {"limit": _sig(lower ** (1 / 3) * upper ** (2 / 3)),
                     "lower": lower, "upper": upper, "upper_from": side,
                     "seeds": len(read)}
    return out


def main(argv=None, *, device="cuda", bench=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds")
    p.add_argument("--controls", default="",
                   help="comma-separated precisions to lower, one control "
                        "each (weights, state)")
    p.add_argument("--fault", choices=("half_batch", "frozen", "half_clients"))
    p.add_argument("--out")
    p.add_argument("--limits", nargs="+",
                   help="calibration files to set the limits from")
    args = p.parse_args(argv)
    for path in (ROOT, ROOT / "src"):
        if str(path) not in sys.path:
            sys.path.insert(0, str(path))
    if args.limits:
        lines = [json.loads(ln) for f in args.limits
                 for ln in open(f) if ln.strip()]
        lims = set_limits([ln for ln in lines
                           if ln["workload"] == args.workload])
        path = ROOT / "fedbench" / "limits" / f"{args.workload}.json"
        path.write_text(json.dumps(lims, indent=1) + "\n")
        print(json.dumps(lims, indent=1))
        return lims
    controls = [c for c in args.controls.split(",") if c]
    import torch

    from fedbench import check
    from fedbench.bench import Bench
    from fedbench.reference.fed import follow

    bench = bench or Bench()
    cell_doc = bench.workload(args.workload)
    cfg_doc = bench.config(cell_doc["config"])
    traffic = bench.traffic(cell_doc["traffic"])
    fed = bench.runner(traffic)
    out = open(args.out, "a") if args.out else None
    lines = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        cell = fed.Cell(cfg_doc, bench.reference(cfg_doc), traffic, seed,
                        device, {})
        cap = fed.Capture(cell, fault=args.fault)
        with cap.installed():
            cell.job(round_progress=cap.on_round)
        t1 = time.perf_counter()
        rec = cap.records()
        del cap
        gc.collect()
        with fed._no_tf32():
            ref = follow(cell.reference, cell.model, traffic, cell.params,
                         cell.lora0, cell.corpus, seed, rec)
            t2 = time.perf_counter()
            sides = [(args.fault or "program", check.numbers(rec, ref))]
            for lower in controls:
                ctl = follow(cell.reference, cell.model, traffic,
                             cell.params, cell.lora0, cell.corpus, seed, rec,
                             lower=(lower,))
                sides.append(("control_" + lower,
                              check.numbers(control_records(ctl), ref)))
        gaps = [g for r in ref["rounds"] for g in r["gaps"].values()]
        for side, nums in sides:
            line = {"workload": args.workload, "seed": seed, "side": side,
                    "numbers": nums, "min_eigen_gap": min(gaps, default=None),
                    "job_s": t1 - t0, "reference_s": t2 - t1,
                    "device": torch.cuda.get_device_name(0)
                    if device == "cuda" else device}
            print(json.dumps(line), flush=True)
            lines.append(line)
            if out:
                out.write(json.dumps(line) + "\n")
                out.flush()
        del cell, rec, ref
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
    return lines


if __name__ == "__main__":
    main()
