"""Wrapper of the Hopper flash-attention forward kernel
(``csrc/flash_attention.cu``): causal / sliding-window / full attention
over whole sequences, in the model layout.

Replaces the TPU kernel ``flash_attention_bhsd`` of the JAX package. The
kernel reads q (B, S, H, D) and k/v (B, S, Hkv, D) through their strides
(any layout whose last dim is contiguous), so the model's tensors go in
without a transpose or a GQA repeat. The wrapper checks device, dtypes,
shapes, strides and alignment and raises on anything the kernel does not
take; it allocates the output, launches on the current stream, raises if
the launch reports an error, and adds one to
``flash_attention_bshd.launches`` per call.

The kernel is built at the first call (``repro_torch.kernels.build``),
never at import. There is no CPU path here: ``dispatch`` gives CPU
tensors to the plain version.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import build

#: widest head the kernel takes
MAX_HEAD_DIM = 256
#: shared memory a block may use on Hopper (bytes)
MAX_SMEM = 227 * 1024

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_BOUND: dict = {}


def _library():
    """(launch, smem_bytes) C functions, typed, building on first use."""
    if not _BOUND:
        lib = build.load("flash_attention")
        launch = lib.flash_attention_launch
        launch.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                           + [ctypes.POINTER(ctypes.c_longlong),
                              ctypes.c_int, ctypes.c_int, ctypes.c_float,
                              ctypes.c_int, ctypes.c_void_p])
        launch.restype = ctypes.c_int
        smem = lib.flash_attention_smem_bytes
        smem.argtypes = [ctypes.c_int, ctypes.c_int]
        smem.restype = ctypes.c_int
        _BOUND.update(launch=launch, smem=smem)
    return _BOUND["launch"], _BOUND["smem"]


def flash_attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         window: Optional[int] = None,
                         scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, S, H, D); k, v: (B, S, Hkv, D), one dtype (f32 or bf16) on
    one CUDA device, H % Hkv == 0. Returns (B, S, H, D) in ``q.dtype``."""
    if q.device.type != "cuda":
        raise ValueError(f"the Hopper flash_attention kernel takes CUDA "
                         f"tensors, got {q.device}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must share one device")
    if q.dtype not in _DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"dtypes q={q.dtype} k={k.dtype} v={v.dtype}: the "
                         f"kernel takes one dtype, f32 or bf16")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"need q (B,S,H,D) and k, v (B,S,Hkv,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, s, h, d = q.shape
    hkv = k.shape[2]
    if k.shape[0] != b or k.shape[1] != s or k.shape[3] != d:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} (same B, S and D)")
    if h % hkv:
        raise ValueError(f"H={h} is not a multiple of Hkv={hkv}")
    if window is not None and window < 1:
        raise ValueError(f"window must be a positive int, got {window}")
    esz = q.element_size()
    if d > MAX_HEAD_DIM or (d * esz) % 16:
        raise ValueError(f"head dim {d} ({q.dtype}): the kernel takes "
                         f"D <= {MAX_HEAD_DIM} with rows of whole 16-byte "
                         f"vectors")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1 or t.data_ptr() % 16 \
                or any((t.stride(i) * esz) % 16 for i in range(3)):
            raise ValueError(f"{name}: the last dim must be contiguous and "
                             f"the start and the B, S, H strides whole "
                             f"16-byte vectors (strides {t.stride()})")
    launch, smem_bytes = _library()
    if smem_bytes(d, _DTYPES[q.dtype]) > MAX_SMEM:
        raise ValueError(f"head dim {d} needs more shared memory than a "
                         f"block has")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    strides = (ctypes.c_longlong * 9)(*q.stride()[:3], *k.stride()[:3],
                                      *v.stride()[:3])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     out.data_ptr(), b, s, h, hkv, d, strides, int(causal),
                     int(window or 0), float(scale), _DTYPES[q.dtype],
                     stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err} (B={b} S={s} H={h} Hkv={hkv} D={d} "
                           f"{q.dtype})")
    flash_attention_bshd.launches += 1
    return out


#: wrapper calls that launched the kernel (one per attention call)
flash_attention_bshd.launches = 0
