#!/usr/bin/env python3
"""The lora_matmul phases of ``chip_smoke.py`` alone, on one H100: build
the kernels, check and time the forward (``lora_phase``) and the input
gradient (``lora_bwd_phase``), then, for each ``--devft`` arch, its DevFT
phase, whose launch checks hold one backward kernel call to each training
forward's lora_matmul. About two minutes of the card without ``--devft``.

    python3 scripts/chip_smoke_lora.py [--no-forward] [--devft ARCH ...]
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
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--no-forward", action="store_true",
                    help="skip the forward's cases")
    ap.add_argument("--devft", nargs="*", default=[],
                    choices=[run[0] for run in C.DEVFT_RUNS],
                    help="DevFT phases to run after the kernel cases")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke_lora: no CUDA device is visible", file=sys.stderr)
        return 2
    from repro_torch.kernels import build, common, ref
    from repro_torch.kernels.lora_matmul import lora_matmul_fused
    from repro_torch.launch.env import setup_environment

    C.BF16_FLOPS, C.F32_FLOPS, C.HBM_BYTES_PER_S = (
        common.H100_BF16_FLOPS, common.H100_F32_FLOPS,
        common.H100_HBM_BYTES_PER_S)
    t0 = time.perf_counter()
    setup_environment("gpu")
    _name, smi, _build_s = C.device_phase(build)
    if not args.no_forward:
        C.lora_phase(lora_matmul_fused, ref.lora_matmul_ref)
    C.lora_bwd_phase()
    for run in C.DEVFT_RUNS:
        if run[0] in args.devft:
            arch, caps, per_kind, forward_layers, depth, _ = run
            C.devft_phase(arch, caps, per_kind, forward_layers, depth)
            torch.cuda.empty_cache()
    print(f"[done] lora_matmul phases {time.perf_counter() - t0:.1f} s on "
          f"{smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
