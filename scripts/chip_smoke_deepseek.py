#!/usr/bin/env python3
"""The DeepSeek-V3 phases of ``chip_smoke.py`` alone, on one H100: build
the kernels, hold ``flash_attention`` at MLA's training shape (B16 S512
H128 D192, v zero-padded) and ``moe_expert_ffn`` at the deepseek-v3-8l
cell's expert share (E8 C8192 d7168 ff2048 with its fill) against their
plain versions, prefill against decoding for deepseek-v3-671b's dense
prefix and for DeepSeek-V3 under its published rules, the published
rules' training step (``deepseek_published_phase``), and with
``--devft`` the registry config's DevFT phase. A few minutes of the card.

    python3 scripts/chip_smoke_deepseek.py [--devft]
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
    ap.add_argument("--devft", action="store_true",
                    help="run deepseek-v3-671b's DevFT phase after the rest")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke_deepseek: no CUDA device is visible",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import build, common, ref
    from repro_torch.kernels.flash_attention import flash_attention_bshd
    from repro_torch.kernels.moe_ffn import moe_expert_ffn_ecd
    from repro_torch.launch.env import setup_environment

    C.BF16_FLOPS, C.F32_FLOPS, C.HBM_BYTES_PER_S = (
        common.H100_BF16_FLOPS, common.H100_F32_FLOPS,
        common.H100_HBM_BYTES_PER_S)
    t0 = time.perf_counter()
    setup_environment("gpu")
    _name, smi, _build_s = C.device_phase(build)
    C.attention_phase(flash_attention_bshd, ref.attention_bshd_ref,
                      only={C.FLASH_MLA})
    C.moe_phase(moe_expert_ffn_ecd, ref.moe_expert_ffn_ref,
                only={C.MOE_DEEPSEEK_SHARE})
    torch.cuda.empty_cache()
    C.prefill_vs_decode_phase(only={"deepseek-v3-671b",
                                    C.PUBLISHED_DEEPSEEK})
    C.deepseek_published_phase()
    if args.devft:
        for run in C.DEVFT_RUNS:
            if run[0] == "deepseek-v3-671b":
                arch, caps, per_kind, forward_layers, depth, _ = run
                C.devft_phase(arch, caps, per_kind, forward_layers, depth)
    print(f"[done] deepseek phases {time.perf_counter() - t0:.1f} s on "
          f"{smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
