"""Process-level set-up for the CLI entry points (train, serve, the
autotuner): the JAX package's ``repro.launch.env``, with what carries
over to PyTorch.

One call, before the first computation::

    from repro_torch.launch.env import setup_environment
    setup_environment()                       # leave the device alone
    setup_environment("gpu", cpu_cores=8)     # explicit

* ``platform="gpu"`` (or ``"cuda"``) requires a visible Hopper card and
  raises without one: there is no CPU fallback. ``"cpu"`` needs nothing.
* Wherever a card is visible, f32 matrix products and convolutions run
  in full f32 (``setup_numerics``): cuBLAS and cuDNN would otherwise be
  free to use TF32, and f32 runs could not be compared with the CPU or
  with the JAX package.
* ``cpu_cores`` sets ``torch.set_num_threads``, clamped to the host's
  cores as JAX clamps its host device count.
* ``x64=True`` makes float64 the default float dtype; otherwise the
  default dtype is left as the caller set it. No environment variable
  switches it: the JAX package's ``JAX_ENABLE_X64``, exported for the
  reference, must not turn the port's path to float64.

The JAX package's XLA flags have no counterpart here. Idempotent: a
second call with the same arguments applies the same settings again.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import torch

from repro_torch.kernels.dispatch import HOPPER

PLATFORMS = ("cpu", "gpu", "cuda")


def setup_numerics() -> None:
    """Full-precision f32 matrix products and convolutions on the card
    (cuBLAS and cuDNN would otherwise be free to use TF32), so f32 runs
    are comparable with the CPU and with the JAX package."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def setup_environment(platform: Optional[str] = None, *,
                      x64: bool = False,
                      cpu_cores: Optional[int] = None) -> Dict[str, object]:
    """Configure the process; returns a dict of what was applied."""
    if platform is not None and platform not in PLATFORMS:
        raise ValueError(f"unknown platform {platform!r}; known: "
                         f"{list(PLATFORMS)}")
    applied: Dict[str, object] = {}
    if platform in ("gpu", "cuda"):
        if not torch.cuda.is_available():
            raise RuntimeError(f"platform={platform!r}: no CUDA device is "
                               f"visible")
        cap = tuple(torch.cuda.get_device_capability(0))
        if cap != HOPPER:
            raise RuntimeError(f"platform={platform!r}: the kernels need "
                               f"compute capability {HOPPER}, the card has "
                               f"{cap}")
        applied["platform"] = "gpu"
        applied["device"] = torch.cuda.get_device_name(0)
    elif platform == "cpu":
        applied["platform"] = "cpu"
    if torch.cuda.is_available():
        setup_numerics()
        applied["tf32"] = False
    if cpu_cores is not None:
        n = max(1, min(int(cpu_cores), os.cpu_count() or 1))
        torch.set_num_threads(n)
        applied["cpu_cores"] = n
    if x64:
        torch.set_default_dtype(torch.float64)
        applied["x64"] = True
    return applied
