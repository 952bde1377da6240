"""Wrapper of the Hopper flash-decode kernel (``csrc/flash_decode.cu``):
single-token attention over ragged per-slot KV caches.

Replaces the TPU kernel ``flash_decode_bhrd`` of the JAX package. The
wrapper checks device, dtypes, shapes, contiguity and alignment and
raises on anything the kernel does not take; it allocates the output
and the split-K workspace, launches the split pass and the combine pass
on the current stream, raises if the launch reports an error, and adds
one to ``flash_decode_bhrd.launches`` per call (one call = one layer of
one decode step, whatever number of CUDA kernels it runs).

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
from repro_torch.kernels.common import round_up

#: keys per tile of the split pass (``kTile`` in the source)
TILE = 128
#: threads per block (``kThreads``): bounds the PV pass's column vectors
THREADS = 128
#: shared memory a block may use on Hopper (bytes)
MAX_SMEM = 227 * 1024
#: split-pass blocks to aim for, per SM, when cutting the cache axis
BLOCKS_PER_SM = 4

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_BOUND: dict = {}


def _library():
    """(launch, smem_bytes) C functions, typed, building on first use."""
    if not _BOUND:
        lib = build.load("flash_decode")
        launch = lib.flash_decode_launch
        launch.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
                           + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                              ctypes.c_void_p])
        launch.restype = ctypes.c_int
        smem = lib.flash_decode_smem_bytes
        smem.argtypes = [ctypes.c_int] * 3
        smem.restype = ctypes.c_int
        _BOUND.update(launch=launch, smem=smem)
    return _BOUND["launch"], _BOUND["smem"]


def split_plan(b: int, h: int, hkv: int, cap: int, n_sm: int):
    """(chunk, nsplit): cut the cache axis into ``nsplit`` chunks of
    ``chunk`` rows (a multiple of TILE) so that the split pass has about
    BLOCKS_PER_SM blocks per SM — B * Hkv alone is far too few."""
    groups = -(-(h // hkv) // 8)
    pairs = b * hkv * groups
    want = -(-BLOCKS_PER_SM * n_sm // pairs)
    nsplit = max(1, min(want, -(-cap // TILE)))
    chunk = round_up(-(-cap // nsplit), TILE)
    return chunk, -(-cap // chunk)


def flash_decode_bhrd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      kv_valid_len: torch.Tensor,
                      scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, 1, H, hd); k: (B, C, Hkv, hd); v: (B, C, Hkv, vd), all on
    one CUDA device; kv_valid_len: (B,) int32. Returns (B, 1, H, vd) in
    ``v.dtype`` (the plain version's dtype)."""
    if q.device.type != "cuda":
        raise ValueError(f"the Hopper flash_decode kernel takes CUDA "
                         f"tensors, got {q.device}")
    if not (q.device == k.device == v.device == kv_valid_len.device):
        raise ValueError("q, k, v and kv_valid_len must share one device")
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"q must be (B, 1, H, hd), got {tuple(q.shape)}")
    b, _, h, hd = q.shape
    if k.dim() != 4 or k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"k must be (B, C, Hkv, hd) for q {tuple(q.shape)}, "
                         f"got {tuple(k.shape)}")
    cap, hkv = k.shape[1], k.shape[2]
    if v.dim() != 4 or tuple(v.shape[:3]) != (b, cap, hkv):
        raise ValueError(f"v must be (B, C, Hkv, vd) like k "
                         f"{tuple(k.shape)}, got {tuple(v.shape)}")
    vd = v.shape[3]
    if h % hkv:
        raise ValueError(f"H={h} is not a multiple of Hkv={hkv}")
    if q.dtype not in _DTYPES or k.dtype not in _DTYPES or k.dtype != v.dtype:
        raise ValueError(f"dtypes q={q.dtype} k={k.dtype} v={v.dtype}: the "
                         f"kernel takes f32/bf16 q and one f32/bf16 cache "
                         f"dtype for k and v")
    if kv_valid_len.dtype != torch.int32 or tuple(kv_valid_len.shape) != (b,):
        raise ValueError(f"kv_valid_len must be int32 (B,), got "
                         f"{kv_valid_len.dtype} {tuple(kv_valid_len.shape)}")
    if not all(t.is_contiguous() for t in (q, k, v, kv_valid_len)):
        raise ValueError("q, k, v and kv_valid_len must be contiguous")
    esz = k.element_size()
    if (hd * esz) % 16 or (vd * esz) % 16 \
            or k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError(f"cache rows must be whole 16-byte vectors "
                         f"(hd={hd}, vd={vd}, {k.dtype}) at 16-byte "
                         f"aligned addresses")
    if vd * esz // 16 > THREADS:
        raise ValueError(f"vd={vd} is wider than one block's columns "
                         f"({THREADS * 16 // esz} for {k.dtype})")
    launch, smem_bytes = _library()
    kv_bf16 = _DTYPES[k.dtype]
    if smem_bytes(hd, vd, kv_bf16) > MAX_SMEM:
        raise ValueError(f"hd={hd}, vd={vd} need more shared memory than "
                         f"a block has")
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    n_sm = torch.cuda.get_device_properties(q.device).multi_processor_count
    chunk, nsplit = split_plan(b, h, hkv, cap, n_sm)

    out = torch.empty((b, 1, h, vd), dtype=v.dtype, device=q.device)
    ws_acc = torch.empty((b, h, nsplit, vd), dtype=torch.float32,
                         device=q.device)
    ws_ml = torch.empty((b, h, nsplit, 2), dtype=torch.float32,
                        device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     kv_valid_len.data_ptr(), out.data_ptr(),
                     ws_acc.data_ptr(), ws_ml.data_ptr(),
                     b, h, hkv, cap, hd, vd, chunk, nsplit, scale,
                     _DTYPES[q.dtype], kv_bf16, stream)
    if err != 0:
        raise RuntimeError(f"flash_decode kernel launch failed: CUDA error "
                           f"{err} (B={b} H={h} Hkv={hkv} C={cap} hd={hd} "
                           f"vd={vd})")
    flash_decode_bhrd.launches += 1
    return out


#: wrapper calls that launched the kernel (one per layer per decode step)
flash_decode_bhrd.launches = 0
