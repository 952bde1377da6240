"""Public kernel entry points in model layout.

Each op resolves through ``repro_torch.kernels.dispatch`` by the device
of its tensors: a CPU tensor runs the plain PyTorch version
(``repro_torch.kernels.ref``), a CUDA tensor launches the Hopper kernel
or raises — there is no fallback to the plain version on the card.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import dispatch


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 kv_valid_len: torch.Tensor,
                 scale: Optional[float] = None) -> torch.Tensor:
    """q: (B,1,H,hd); k: (B,C,Hkv,hd); v: (B,C,Hkv,vd) cache-resident;
    kv_valid_len (B,) int32 masks each slot's dead cache entries.
    Returns (B,1,H,vd) in ``v.dtype``; a slot with ``valid == 0`` gives
    exact zeros. Inference only (no autograd)."""
    return dispatch.get_kernel("flash_decode", "auto", q.device)(
        q, k, v, kv_valid_len=kv_valid_len, scale=scale)
