"""Wrapper of the Hopper batched expert SwiGLU kernel
(``csrc/moe_ffn.cu``): ``(silu(buf @ wg) * (buf @ wu)) @ wd`` per expert
over (E, C, d) capacity buffers.

Replaces the TPU kernel ``moe_expert_ffn_ecd`` of the JAX package. The
wrapper checks device, dtypes, shapes and contiguity and raises on
anything the kernel does not take; it allocates the output and the
(E, C, ff) hidden the kernel's two passes hand to each other, launches
on the current stream, raises if the launch reports an error, and adds
one to ``moe_expert_ffn_ecd.launches`` per call.

The kernel is built at the first call (``repro_torch.kernels.build``),
never at import. There is no CPU path here: ``dispatch`` gives CPU
tensors to the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_BOUND: dict = {}


def _launch_fn():
    if not _BOUND:
        fn = build.load("moe_ffn").moe_ffn_launch
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _BOUND["launch"] = fn
    return _BOUND["launch"]


def moe_expert_ffn_ecd(buf: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                       wd: torch.Tensor) -> torch.Tensor:
    """buf: (E, C, d); wg, wu: (E, d, ff); wd: (E, ff, d), one dtype (f32
    or bf16), contiguous, on one CUDA device. Returns (E, C, d) in
    ``buf.dtype``: f32 accumulation, one rounding at the end (in bf16 the
    hidden is rounded to bf16 for the tensor cores)."""
    tensors = (buf, wg, wu, wd)
    if buf.device.type != "cuda":
        raise ValueError(f"the Hopper moe_expert_ffn kernel takes CUDA "
                         f"tensors, got {buf.device}")
    if not all(t.device == buf.device for t in tensors):
        raise ValueError("buf, wg, wu and wd must share one device")
    if buf.dtype not in _DTYPES or not all(t.dtype == buf.dtype
                                           for t in tensors):
        raise ValueError(f"dtypes buf={buf.dtype} wg={wg.dtype} "
                         f"wu={wu.dtype} wd={wd.dtype}: the kernel takes one "
                         f"dtype, f32 or bf16, for all four")
    if buf.dim() != 3 or wg.dim() != 3:
        raise ValueError(f"shapes buf={tuple(buf.shape)} "
                         f"wg={tuple(wg.shape)}: need buf (E, C, d), "
                         f"wg (E, d, ff)")
    e, c, d = buf.shape
    ff = wg.shape[2]
    if wg.shape != (e, d, ff) or wu.shape != (e, d, ff) \
            or wd.shape != (e, ff, d):
        raise ValueError(f"shapes buf={tuple(buf.shape)} wg={tuple(wg.shape)}"
                         f" wu={tuple(wu.shape)} wd={tuple(wd.shape)} "
                         f"disagree: need wg/wu (E, d, ff), wd (E, ff, d)")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("buf, wg, wu and wd must be contiguous")
    out = torch.empty_like(buf)
    if out.numel() == 0 or ff == 0:
        return out.zero_()
    hidden = torch.empty((e, c, ff), dtype=buf.dtype, device=buf.device)
    per_vec = 16 // buf.element_size()
    vec = int(d % per_vec == 0 and ff % per_vec == 0
              and all(t.data_ptr() % 16 == 0 for t in tensors))
    launch = _launch_fn()
    with torch.cuda.device(buf.device):
        stream = torch.cuda.current_stream(buf.device).cuda_stream
        err = launch(buf.data_ptr(), wg.data_ptr(), wu.data_ptr(),
                     wd.data_ptr(), hidden.data_ptr(), out.data_ptr(),
                     e, c, d, ff, _DTYPES[buf.dtype], vec, stream)
    if err != 0:
        raise RuntimeError(f"moe_expert_ffn kernel launch failed: CUDA error "
                           f"{err} (E={e} C={c} d={d} ff={ff} {buf.dtype})")
    moe_expert_ffn_ecd.launches += 1
    return out


#: wrapper calls that launched the kernel
moe_expert_ffn_ecd.launches = 0
