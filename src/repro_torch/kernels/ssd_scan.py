"""Wrapper of the Hopper Mamba-2 chunked SSD forward kernel
(``csrc/ssd_scan.cu``), in model layout.

Replaces the TPU kernel ``ssd_scan`` of the JAX package. x, b and c are
read in place through their strides (on the model path they are slices
of the conv output, so they are not contiguous); only their last axis
must be dense. b and c stay per group: the kernel indexes group
``h // (H / G)`` and nothing is repeated to H heads in memory. The
wrapper checks device, dtypes, shapes and strides and raises on what
the kernel does not take; it allocates the output, launches on the
current stream, raises if the launch reports an error, and adds one to
``ssd_scan_bshp.launches`` per call.

The kernel is built at the first call (``repro_torch.kernels.build``),
never at import. There is no CPU path here: ``dispatch`` gives CPU
tensors to the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

#: limits of the kernel's shared-memory tiles
MAX_HEAD_DIM = 64
MAX_STATE = 128
MAX_CHUNK = 512

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_BOUND: dict = {}


def _launch_fn():
    if not _BOUND:
        fn = build.load("ssd_scan").ssd_scan_launch
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                       + [ctypes.c_longlong] * 12
                       + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _BOUND["launch"] = fn
    return _BOUND["launch"]


def ssd_scan_bshp(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                  b: torch.Tensor, c: torch.Tensor, d: torch.Tensor, *,
                  chunk: int = 128) -> torch.Tensor:
    """x (B, S, H, P); dt (B, S, H) f32; a, d (H,) f32; b, c (B, S, G, N)
    in x's dtype (f32 or bf16), all on one CUDA device. Returns y
    (B, S, H, P) in ``x.dtype``, contiguous. A chunk longer than S is one
    chunk of S rows; a ragged last chunk is shorter."""
    if x.device.type != "cuda":
        raise ValueError(f"the Hopper ssd_scan kernel takes CUDA tensors, "
                         f"got {x.device}")
    if any(t.device != x.device for t in (dt, a, b, c, d)):
        raise ValueError("x, dt, a, b, c and d must share one device")
    if x.dtype not in _DTYPES or not x.dtype == b.dtype == c.dtype:
        raise ValueError(f"dtypes x={x.dtype} b={b.dtype} c={c.dtype}: the "
                         f"kernel takes one dtype, f32 or bf16, for all three")
    if not dt.dtype == a.dtype == d.dtype == torch.float32:
        raise ValueError(f"dtypes dt={dt.dtype} a={a.dtype} d={d.dtype}: "
                         f"the kernel takes f32")
    if x.dim() != 4 or b.dim() != 4 or c.dim() != 4 or dt.dim() != 3:
        raise ValueError(f"shapes x={tuple(x.shape)} dt={tuple(dt.shape)} "
                         f"b={tuple(b.shape)} c={tuple(c.shape)}: need x "
                         f"(B,S,H,P), dt (B,S,H), b/c (B,S,G,N)")
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    chunk = max(1, min(int(chunk), s))
    if (tuple(dt.shape) != (bsz, s, h) or tuple(b.shape) != (bsz, s, g, n)
            or c.shape != b.shape or tuple(a.shape) != (h,)
            or tuple(d.shape) != (h,) or h % g):
        raise ValueError(f"shapes x={tuple(x.shape)} dt={tuple(dt.shape)} "
                         f"a={tuple(a.shape)} b={tuple(b.shape)} "
                         f"c={tuple(c.shape)} d={tuple(d.shape)} disagree")
    if not (1 <= p <= MAX_HEAD_DIM and 1 <= n <= MAX_STATE
            and 1 <= chunk <= MAX_CHUNK):
        raise ValueError(f"P={p} N={n} chunk={chunk}: the kernel takes P <= "
                         f"{MAX_HEAD_DIM}, N <= {MAX_STATE}, chunk <= "
                         f"{MAX_CHUNK}")
    if x.stride(3) != 1 or b.stride(3) != 1 or c.stride(3) != 1:
        raise ValueError("x, b and c must be dense along their last axis")
    if not (a.is_contiguous() and d.is_contiguous()):
        raise ValueError("a and d must be contiguous")
    y = torch.empty((bsz, s, h, p), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    launch = _launch_fn()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = launch(x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
                     c.data_ptr(), d.data_ptr(), y.data_ptr(), bsz, s, h, p,
                     g, n, chunk, *x.stride()[:3], *dt.stride(),
                     *b.stride()[:3], *c.stride()[:3], _DTYPES[x.dtype],
                     stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {err} "
                           f"(B={bsz} S={s} H={h} P={p} G={g} N={n} "
                           f"chunk={chunk} {x.dtype})")
    ssd_scan_bshp.launches += 1
    return y


#: wrapper calls that launched the kernel
ssd_scan_bshp.launches = 0
