"""Wrapper of the Hopper flash-attention forward kernel
(``csrc/flash_attention.cu``): causal / sliding-window / full attention
over whole sequences, in the model layout.

Replaces the TPU kernel ``flash_attention_bhsd`` of the JAX package. The
kernel reads q (B, S, H, D) and k/v (B, S, Hkv, D) through their strides
(any layout whose last dim is contiguous), so the model's tensors go in
without a transpose or a GQA repeat. At the training paths' shapes it is
bound by bytes (llama2-7b-proxy, D 128) or by operations (granite-moe-
1b-a400m, D 64); the source's note says why.

``plan`` decides everything about a call on the host and is pure, so the
CPU tests hold it at every path shape. Its variant, by dtype and head
dim:

* ``wgmma`` (bf16, D 64 or 128): 128-row q tiles, a TMA ring of 128-key
  K/V tiles, two warpgroups running Q.K^T and P.V on wgmma with P from
  registers under FA3's schedule (a tile's softmax overlaps the previous
  tile's P.V, and the warpgroups take turns on the tensor cores), the
  mask only on edge tiles, a TMA-stored epilogue. Its softmax takes the
  running max on the unscaled scores, so it needs scale > 0;
* ``mma_sync`` (bf16, any other D <= 256, or scale <= 0): the first
  design, mma.sync on 64-row q tiles with cp.async double buffering;
* ``fma_f32`` (f32): CUDA-core FMA.

``run_plan`` launches one plan uncounted, so a measurement can time the
``mma_sync`` variant on inputs the wrapper gives to ``wgmma``;
``flash_attention_bshd`` never forces a variant. The wrapper checks
device, dtypes, shapes, strides and alignment and raises on anything the
kernel does not take; it allocates the output, launches on the current
stream and raises if the launch reports an error. Per call it adds one
to ``flash_attention_bshd.launches`` and one to
``flash_attention_bshd.variants[variant]``.

The kernel is built at the first call (``repro_torch.kernels.build``),
never at import. There is no CPU path here: ``dispatch`` gives CPU
tensors to the plain version.
"""
from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

#: widest head the kernel takes
MAX_HEAD_DIM = 256
#: shared memory a block may use on Hopper (bytes)
MAX_SMEM = 227 * 1024

_DTYPES = (torch.float32, torch.bfloat16)
#: variant codes of the C interface
_VARIANTS = {"fma_f32": 0, "mma_sync": 1, "wgmma": 2}
#: head dims the wgmma variant takes, with the depth of its K/V ring
WGMMA_STAGES = {128: 3, 64: 4}
_BOUND: dict = {}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _padded_dim(d: int) -> int:
    return 32 if d <= 32 else 64 if d <= 64 else 128 if d <= 128 else 256


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one call runs. ``variant``: ``wgmma``, ``mma_sync`` or
    ``fma_f32``. ``block_q`` / ``block_kv``: the q rows of a block and the
    keys of a K/V tile. ``stages``: the K/V tiles in flight (the wgmma
    ring's depth; cp.async's double buffer; 1 for the synchronous f32
    loads). ``grid``: (q tiles, H, B) blocks. ``smem``: dynamic shared
    memory per block (bytes). ``tiles``: the (q tile, kv tile) pairs the
    blocks of one (batch, head) visit."""
    variant: str
    block_q: int
    block_kv: int
    stages: int
    grid: Tuple[int, int, int]
    smem: int
    tiles: int


def smem_bytes(variant: str, d: int, stages: int) -> int:
    """Shared memory of one block, as ``flash_attention_smem_bytes`` of
    the C interface computes it."""
    dp = _padded_dim(d)
    if variant == "wgmma":   # the q tile, the ring, barriers, alignment
        return (2 * (d // 64) * 64 * 128 + stages * 2 * (d // 64) * 128 * 128
                + 8 * (1 + 2 * stages) + 1024)
    if variant == "mma_sync":
        return 2 * 2 * 64 * (dp + 8) * 2
    if variant == "fma_f32":
        return ((32 + 2 * 32) * (dp + 4) + 32 * 32) * 4
    raise ValueError(f"unknown flash_attention variant {variant!r}")


def _tiles(s: int, bq: int, bkv: int, causal: bool,
           window: Optional[int]) -> int:
    """The kv tiles each q tile's loop visits, summed (the kernels' loop
    bounds: causal skipping above, the window below)."""
    total = 0
    for t in range(_cdiv(s, bq)):
        q0 = t * bq
        lo = max(0, q0 - window + 1) if window else 0
        hi = min(s, q0 + bq) if causal else s
        total += _cdiv(hi, bkv) - lo // bkv
    return total


def _tiles_of(variant: str, d: int) -> Tuple[int, int, int]:
    """(block_q, block_kv, stages) of ``variant`` at head dim ``d``: the
    one tiling each variant instantiates."""
    if variant == "wgmma":
        return 128, 128, WGMMA_STAGES[d]
    return (64, 64, 2) if variant == "mma_sync" else (32, 32, 1)


@functools.lru_cache(maxsize=256)
def plan(b: int, s: int, h: int, hkv: int, d: int, dtype: torch.dtype,
         causal: bool = True, window: Optional[int] = None, *,
         positive_scale: bool = True,
         variant: Optional[str] = None, block_q: Optional[int] = None,
         block_kv: Optional[int] = None,
         stages: Optional[int] = None) -> Plan:
    """The plan of a call with q (b, s, h, d) and k, v (b, s, hkv, d) of
    ``dtype`` (cached: a training path asks for a few shapes many times).
    ``variant`` forces another variant than the plan's own (for
    measurements). ``block_q``, ``block_kv``, ``stages`` (the autotuner's
    knobs; one left out keeps the plan's own) select the variant that
    instantiates that tiling. Raises where the kernel does not take the
    call."""
    if min(b, s, h, hkv, d) < 1 or h % hkv:
        raise ValueError(f"flash_attention B={b} S={s} H={h} Hkv={hkv} "
                         f"D={d}: need positive sizes and H % Hkv == 0")
    if dtype not in _DTYPES:
        raise ValueError(f"the flash_attention kernel takes f32 or bf16, "
                         f"got {dtype}")
    esz = 2 if dtype == torch.bfloat16 else 4
    if d > MAX_HEAD_DIM or (d * esz) % 16:
        raise ValueError(f"head dim {d} ({dtype}): the kernel takes "
                         f"D <= {MAX_HEAD_DIM} with rows of whole 16-byte "
                         f"vectors")
    if window is not None and window < 1:
        raise ValueError(f"window must be a positive int, got {window}")
    takes = [v for v in ("wgmma", "mma_sync", "fma_f32")
             if (v == "fma_f32") == (dtype == torch.float32)
             and (v != "wgmma" or (d in WGMMA_STAGES and positive_scale))]
    if variant is not None and variant not in _VARIANTS:
        raise ValueError(f"unknown flash_attention variant {variant!r}")
    if variant is not None and variant not in takes:
        raise ValueError(f"variant {variant} does not take {dtype} D={d} "
                         f"(positive scale: {positive_scale})")
    forced, variant = variant, variant or takes[0]
    if (block_q, block_kv, stages) != (None, None, None):
        want = tuple(o if k is None else k for o, k in zip(
            _tiles_of(variant, d), (block_q, block_kv, stages)))
        tiled = [v for v in takes if _tiles_of(v, d) == want]
        if not tiled or (forced and forced not in tiled):
            raise ValueError(
                f"flash_attention {dtype} D={d}: no variant tiles "
                f"(block_q, block_kv, stages) = {want}; it takes "
                f"{[_tiles_of(v, d) for v in takes]}")
        variant = forced or tiled[0]
    bq, bkv, stages = _tiles_of(variant, d)
    smem = smem_bytes(variant, d, stages)
    if smem > MAX_SMEM:
        raise ValueError(f"head dim {d} needs {smem} bytes of shared memory, "
                         f"more than a block has")
    return Plan(variant, bq, bkv, stages, (_cdiv(s, bq), h, b), smem,
                _tiles(s, bq, bkv, causal, window))


def knobs(p: Plan) -> dict:
    """The autotuner's knobs of plan ``p``."""
    return {"block_q": p.block_q, "block_kv": p.block_kv,
            "stages": p.stages}


def _library():
    """The kernel library, its C functions typed, building on first use."""
    if not _BOUND:
        lib = build.load("flash_attention")
        i = ctypes.c_int
        launch = lib.flash_attention_launch
        launch.argtypes = ([ctypes.c_void_p] * 4 + [i] * 5
                           + [ctypes.POINTER(ctypes.c_longlong), i, i,
                              ctypes.c_float, i, i, i, ctypes.c_void_p])
        launch.restype = i
        lib.flash_attention_smem_bytes.argtypes = [i, i, i]
        lib.flash_attention_smem_bytes.restype = i
        _BOUND["lib"] = lib
    return _BOUND["lib"]


def library_smem_bytes(p: Plan, d: int) -> int:
    """What the C interface says plan ``p`` needs at head dim ``d`` (for
    a check against ``p.smem``, which mirrors it)."""
    return _library().flash_attention_smem_bytes(_VARIANTS[p.variant], d,
                                                 p.stages)


def run_plan(p: Plan, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             *, causal: bool, window: Optional[int], scale: float
             ) -> torch.Tensor:
    """One launch of plan ``p`` (from ``plan`` at these shapes) on checked
    CUDA tensors, counted nowhere; returns the (B, S, H, D) output."""
    b, s, h, d = q.shape
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 9)(*q.stride()[:3], *k.stride()[:3],
                                      *v.stride()[:3])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _library().flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s,
            h, k.shape[2], d, strides, int(causal), int(window or 0),
            float(scale), _VARIANTS[p.variant], p.stages, p.grid[0], stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err} (B={b} S={s} H={h} Hkv={k.shape[2]} "
                           f"D={d} {q.dtype} {p})")
    return out


def flash_attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         window: Optional[int] = None,
                         scale: Optional[float] = None,
                         block_q: Optional[int] = None,
                         block_kv: Optional[int] = None,
                         stages: Optional[int] = None) -> torch.Tensor:
    """q: (B, S, H, D); k, v: (B, S, Hkv, D), one dtype (f32 or bf16) on
    one CUDA device, H % Hkv == 0. ``block_q``, ``block_kv`` and
    ``stages`` override the plan's tiling (``plan``). Returns (B, S, H,
    D) in ``q.dtype``."""
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
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if q.numel() == 0:
        return torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    p = plan(b, s, h, hkv, d, q.dtype, causal, window,
             positive_scale=scale > 0, block_q=block_q, block_kv=block_kv,
             stages=stages)
    out = run_plan(p, q, k, v, causal=causal, window=window, scale=scale)
    flash_attention_bshd.launches += 1
    flash_attention_bshd.variants[p.variant] += 1
    return out



def reset_counts() -> None:
    """Zero the counts: ``launches`` (wrapper calls that launched the
    kernel, one per attention call) and ``variants`` (those calls by
    variant)."""
    flash_attention_bshd.launches = 0
    flash_attention_bshd.variants = collections.Counter()


reset_counts()
