"""One run of ``fedbench/run.py`` on the CPU over a benchmark folder, in a
process of its own: the tests' process may hold JAX (the repo's own
``tests/conftest.py`` imports it), and a run's forbidden-module check
would then end the run.

    python3 fedbench/tests/run_cpu.py --here <folder> --bench-json <file> \
        [--fault half_batch|frozen|half_clients] -- <run.py arguments>

``--fault`` plants that fault in the program (``Capture``'s), so the run
judges a broken timed path.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for _p in (ROOT, ROOT / "src"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--here", required=True)
    p.add_argument("--bench-json", required=True)
    p.add_argument("--fault")
    p.add_argument("run_args", nargs=argparse.REMAINDER)
    args = p.parse_args(argv)
    import torch

    from fedbench import run
    from fedbench.bench import Bench

    torch.set_num_threads(1)
    bench = Bench(here=Path(args.here), bench_json=Path(args.bench_json))
    run_args = [a for a in args.run_args if a != "--"]
    if args.fault:
        workload = run_args[run_args.index("--workload") + 1]
        fed = bench.runner(bench.traffic(bench.workload(workload)["traffic"]))
        init = fed.Capture.__init__

        def planted(self, cell, **_):
            init(self, cell, fault=args.fault)
        fed.Capture.__init__ = planted
    return run.main(run_args, device="cpu", bench=bench)


if __name__ == "__main__":
    sys.exit(main())
