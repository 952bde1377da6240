#!/usr/bin/env python3
"""The mesh phase of ``chip_smoke.py`` alone, on one H100: build the
kernels, run granite-moe-1b-a400m's DevFT phase (``mesh=None``), then
``mesh_phase`` against it (the same run on the 1x1 ``nccl`` mesh, and a
train step on each MoE path). About a minute of the card.

    python3 scripts/chip_smoke_mesh.py      # from the root of a checkout
"""
from __future__ import annotations

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import torch  # noqa: E402

import chip_smoke as C  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke_mesh: no CUDA device is visible", file=sys.stderr)
        return 2
    from repro_torch.interop import tree_map
    from repro_torch.kernels import build, common
    from repro_torch.launch.env import setup_environment

    C.BF16_FLOPS, C.F32_FLOPS, C.HBM_BYTES_PER_S = (
        common.H100_BF16_FLOPS, common.H100_F32_FLOPS,
        common.H100_HBM_BYTES_PER_S)
    t0 = time.perf_counter()
    setup_environment("gpu")
    _name, smi, _build_s = C.device_phase(build)
    arch, caps, per_kind, forward_layers, depth, _ = C.DEVFT_RUNS[0]
    launches, result, base, cfg = C.devft_phase(arch, caps, per_kind,
                                                forward_layers, depth)
    run = (result.spec, result.logs,
           tree_map(lambda t: t.cpu(), result.final_lora),
           tree_map(lambda t: t.cpu(), base), cfg, launches)
    del result, base
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    out = C.mesh_phase(run)
    print(f"[done] mesh phase {time.perf_counter() - t1:.1f} s, all "
          f"{time.perf_counter() - t0:.1f} s on {smi}; launches {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
