#!/usr/bin/env python3
"""The port's one-card dry-run for every arch at every input shape, as a
table: runs ``python -m repro_torch.launch.dryrun`` (its ``main``) once
per cell on meta tensors, on the CPU, writing each cell's JSON to
``--out-dir``, then prints one markdown row per cell: whether the step
fits one H100 (80 GB), its peak, and its roofline times at the H100
SXM's datasheet peaks. Nothing is allocated and no card is needed.

    PYTHONPATH=src python scripts/dryrun_torch_table.py \\
        [--out-dir experiments/dryrun_torch] [--remat true]
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys

from repro_torch.configs import ALL_ARCH_IDS, INPUT_SHAPES
from repro_torch.launch import dryrun


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out-dir", default="experiments/dryrun_torch")
    ap.add_argument("--remat", default="true")
    args = ap.parse_args(argv)
    print("| arch | shape | fits | peak GiB | t_compute ms | t_memory ms "
          "| bottleneck | kernel stand-ins |")
    print("| --- | --- | --- | --- | --- | --- | --- | --- |")
    for arch in ALL_ARCH_IDS:
        for shape in INPUT_SHAPES:
            with contextlib.redirect_stdout(io.StringIO()):
                dryrun.main(["--arch", arch, "--shape", shape,
                             "--remat", args.remat,
                             "--out-dir", args.out_dir])
            with open(os.path.join(args.out_dir,
                                   f"{arch}_{shape}.json")) as f:
                r = json.load(f)
            calls = ", ".join(f"{k} {v}" for k, v in
                              sorted(r["shape_counted_ops"].items()))
            print(f"| {arch} | {shape} | {'yes' if r['fits'] else 'no'} | "
                  f"{r['peak_bytes'] / 2**30:,.2f} | "
                  f"{r['t_compute'] * 1e3:,.2f} | "
                  f"{r['t_memory'] * 1e3:,.2f} | {r['bottleneck']} | "
                  f"{calls or '-'} |", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
