#!/usr/bin/env python3
"""The examples phase of ``chip_smoke.py`` alone, on one H100: build the
kernels, then ``examples_phase`` (the four ``examples/torch_*.py``
through their ``main(argv)`` on the card, with their launch counts and
checks). About two minutes of the card.

    python3 scripts/chip_smoke_examples.py    # from the root of a checkout
"""
from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import torch  # noqa: E402

import chip_smoke as C  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke_examples: no CUDA device is visible",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import build, common
    from repro_torch.launch.env import setup_environment

    C.BF16_FLOPS, C.F32_FLOPS, C.HBM_BYTES_PER_S = (
        common.H100_BF16_FLOPS, common.H100_F32_FLOPS,
        common.H100_HBM_BYTES_PER_S)
    t0 = time.perf_counter()
    setup_environment("gpu")
    _name, smi, _build_s = C.device_phase(build)
    t1 = time.perf_counter()
    launches = C.examples_phase()
    print(f"[done] examples phase {time.perf_counter() - t1:.1f} s, all "
          f"{time.perf_counter() - t0:.1f} s on {smi}; launches "
          f"{json.dumps(launches)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
