#!/usr/bin/env python3
"""The contracts phase of ``chip_smoke.py`` alone, on one H100: build the
kernels, run ``contracts_phase`` (C001 and C003 on the card, C002 on meta
tensors, the per-wrapper sync counts), then serve ``--arch`` at full
width through ``serve_arch_phase``, which counts one engine step's
synchronizing calls and holds the engine to its ``StepContract``. About
a minute of the card with the default arch.

    python3 scripts/chip_smoke_contracts.py [--arch ARCH ...]
"""
from __future__ import annotations

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import torch  # noqa: E402

import chip_smoke as C  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", action="append", choices=sorted(C.SERVE_ARCHS),
                    help="served arch (repeatable; default granite-moe-1b-"
                         "a400m)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke_contracts: no CUDA device is visible",
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
    C.contracts_phase()
    t2 = time.perf_counter()
    for arch in args.arch or ["granite-moe-1b-a400m"]:
        C.serve_arch_phase(arch)
    print(f"[done] contracts phase {t2 - t1:.1f} s, all "
          f"{time.perf_counter() - t0:.1f} s on {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
