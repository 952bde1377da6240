"""Wrapper of the Hopper fused frozen-weight + LoRA matmul kernel
(``csrc/lora_matmul.cu``): ``x @ w + scaling * ((x @ a) @ b)``.

Replaces the TPU kernel ``lora_matmul`` of the JAX package. The wrapper
flattens the leading dims of ``x``, checks device, dtypes, shapes,
contiguity and alignment and raises on anything the kernel does not
take; it allocates the output, launches on the current stream, raises if
the launch reports an error, and adds one to ``lora_matmul_fused.launches``
per call.

The kernel is built at the first call (``repro_torch.kernels.build``),
never at import. There is no CPU path here: ``dispatch`` gives CPU
tensors to the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

#: largest LoRA rank the kernel takes (four 16-wide MMA tiles)
MAX_RANK = 64

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_BOUND: dict = {}


def _launch_fn():
    if not _BOUND:
        fn = build.load("lora_matmul").lora_matmul_launch
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _BOUND["launch"] = fn
    return _BOUND["launch"]


def lora_matmul_fused(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                      b: torch.Tensor, *, scaling: float = 1.0
                      ) -> torch.Tensor:
    """x: (..., K); w: (K, N); a: (K, r); b: (r, N), all one dtype (f32
    or bf16) on one CUDA device. ``scaling`` (alpha / r) is a Python
    number, passed by value. Returns (..., N) in ``x.dtype``."""
    if x.device.type != "cuda":
        raise ValueError(f"the Hopper lora_matmul kernel takes CUDA tensors, "
                         f"got {x.device}")
    if not (x.device == w.device == a.device == b.device):
        raise ValueError("x, w, a and b must share one device")
    if x.dtype not in _DTYPES or not (x.dtype == w.dtype == a.dtype
                                      == b.dtype):
        raise ValueError(f"dtypes x={x.dtype} w={w.dtype} a={a.dtype} "
                         f"b={b.dtype}: the kernel takes one dtype, f32 or "
                         f"bf16, for all four")
    if x.dim() < 1 or w.dim() != 2 or a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"shapes x={tuple(x.shape)} w={tuple(w.shape)} "
                         f"a={tuple(a.shape)} b={tuple(b.shape)}: need "
                         f"x (..., K), w (K, N), a (K, r), b (r, N)")
    k_dim, n = w.shape
    r = a.shape[1]
    if x.shape[-1] != k_dim or a.shape[0] != k_dim or b.shape != (r, n):
        raise ValueError(f"shapes x={tuple(x.shape)} w={tuple(w.shape)} "
                         f"a={tuple(a.shape)} b={tuple(b.shape)} disagree")
    if not 1 <= r <= MAX_RANK:
        raise ValueError(f"LoRA rank {r} outside 1..{MAX_RANK}")
    if not all(t.is_contiguous() for t in (x, w, a, b)):
        raise ValueError("x, w, a and b must be contiguous")
    if any(t.data_ptr() % 16 for t in (x, w, a, b)):
        raise ValueError("x, w, a and b must start at 16-byte aligned "
                         "addresses")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k_dim)
    m = x2.shape[0]
    out = torch.empty((*lead, n), dtype=x.dtype, device=x.device)
    if m == 0:
        return out
    per_vec = 16 // x.element_size()
    vec = int(k_dim % per_vec == 0 and n % per_vec == 0 and r % per_vec == 0)
    launch = _launch_fn()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = launch(x2.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(),
                     out.data_ptr(), m, n, k_dim, r, float(scaling),
                     _DTYPES[x.dtype], vec, stream)
    if err != 0:
        raise RuntimeError(f"lora_matmul kernel launch failed: CUDA error "
                           f"{err} (M={m} N={n} K={k_dim} r={r} {x.dtype})")
    lora_matmul_fused.launches += 1
    return out


#: wrapper calls that launched the kernel
lora_matmul_fused.launches = 0
