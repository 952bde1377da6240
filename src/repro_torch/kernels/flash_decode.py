"""Wrapper of the Hopper flash-decode kernel (``csrc/flash_decode.cu``):
single-token attention over ragged per-slot KV caches.

Replaces the TPU kernel ``flash_decode_bhrd`` of the JAX package.
``plan`` decides everything about a call on the host from shapes and
dtypes alone (it never reads ``kv_valid_len``, which lives on the card)
and is pure, so the CPU tests hold it at every decoding config. Its
variant, by dtype and shape, never because something failed:

* ``tma_mma`` (bf16 q and cache, hd and vd multiples of 16 up to 128,
  rep = H / Hkv <= 16, a ring of at least 4 stages in shared memory):
  every block reads ``kv_valid_len`` itself and walks the list of live
  (slot, chunk, kv head) items (``live_chunks`` below spells the list's
  arithmetic) with stride ``gridDim.x``; a producer thread keeps 64-key
  K/V tiles in flight by TMA, two groups of four warps take turns on them
  and run q.K^T and P.V on ``mma.sync`` tensor cores with P in
  registers; the block that completes a (slot, kv head)'s count of live
  chunks merges their partials, so a call is one kernel. Its workspace
  and counters are cached per device and kept between calls, so two
  calls on two streams at once are not supported (serving runs on one
  stream);
* ``fma`` (f32 q or cache, and any shape ``tma_mma`` does not take):
  the first design, split-K over the capacity with CUDA-core FMA and a
  combine kernel.

``run_plan`` launches one plan uncounted, so a measurement can time the
``fma`` design on inputs the wrapper gives to ``tma_mma``;
``flash_decode_bhrd`` never forces a variant. The wrapper checks device,
dtypes, shapes, contiguity and alignment and raises on anything the
kernel does not take; it allocates the output (and fma's split
workspace), launches on the current stream, raises if the launch
reports an error, and per call adds one to
``flash_decode_bhrd.launches`` and one to
``flash_decode_bhrd.variants[variant]`` (one call = one layer of one
decode step, whatever number of CUDA kernels it runs).

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
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import round_up

#: keys per tile of the fma split pass (``kTile`` in the source)
TILE = 128
#: threads per block of the fma split pass (``kThreads``): bounds the PV
#: pass's column vectors
THREADS = 128
#: query heads of one kv head per fma block (``kMaxRep``)
FMA_MAX_REP = 8
#: shared memory a block may use on Hopper (bytes)
MAX_SMEM = 227 * 1024
#: fma split-pass blocks to aim for, per SM, when cutting the cache axis
BLOCKS_PER_SM = 4

#: keys per ring stage of tma_mma (``mm::TILE``)
MMA_TILE = 64
#: ring depth of tma_mma: the most stages it takes, and the fewest it runs
MMA_MAX_STAGES, MMA_MIN_STAGES = 8, 4
#: widest head (hd and vd) tma_mma takes, and the most query heads per kv
#: head (one m16 tile)
MMA_MAX_DIM, MMA_MAX_REP = 128, 16
#: most slots tma_mma takes (its live list lives in shared memory)
MMA_MAX_SLOTS = 4096
#: chunks a full slot is cut into by tma_mma, at most
MMA_MAX_CHUNKS = 4

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: variant codes of the C interface
_VARIANTS = {"fma": 0, "tma_mma": 1}
_BOUND: dict = {}
#: tma_mma's workspace and its zeroed (slot, kv head) counters, per device
_WORKSPACE: dict = {}
_COUNTERS: dict = {}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one call runs. ``variant``: ``tma_mma`` or ``fma``. ``chunk``:
    cache rows of one work item (a split); ``nchunk`` = ceil(C / chunk),
    the chunks of a full slot. ``grid``: the main kernel's blocks (x, y,
    z). ``stages``: K/V tiles in the ring (1 for fma's synchronous loads).
    ``smem``: dynamic shared memory per block (bytes)."""
    variant: str
    chunk: int
    nchunk: int
    grid: Tuple[int, int, int]
    stages: int
    smem: int


def split_plan(b: int, h: int, hkv: int, cap: int, n_sm: int):
    """(chunk, nsplit) of the fma variant: cut the cache axis into
    ``nsplit`` chunks of ``chunk`` rows (a multiple of TILE) so that the
    split pass has about BLOCKS_PER_SM blocks per SM — B * Hkv alone is
    far too few."""
    groups = -(-(h // hkv) // 8)
    pairs = b * hkv * groups
    want = -(-BLOCKS_PER_SM * n_sm // pairs)
    nsplit = max(1, min(want, -(-cap // TILE)))
    chunk = round_up(-(-cap // nsplit), TILE)
    return chunk, -(-cap // chunk)


def mma_chunk(b: int, hkv: int, cap: int, n_sm: int) -> int:
    """Cache rows per tma_mma work item, a multiple of MMA_TILE: as long as
    a quarter of the cache (each item carries a fixed cost: its q, the
    merge of its warps' partials, and one more partial for the final
    merge to read), but short enough that a full cache gives every SM an
    item."""
    want = min(_cdiv(cap, MMA_MAX_CHUNKS), _cdiv(b * hkv * cap, n_sm))
    return round_up(max(MMA_TILE, want), MMA_TILE)


def fma_smem_bytes(hd: int, vd: int, kv_dtype: torch.dtype) -> int:
    """Shared memory of one fma split block (``split_smem_floats``)."""
    vec = 16 // (2 if kv_dtype == torch.bfloat16 else 4)
    nrg = THREADS // (vd // vec)
    return 4 * (FMA_MAX_REP * ((hd + 3) & ~3) + FMA_MAX_REP * TILE
                + 3 * FMA_MAX_REP + nrg * FMA_MAX_REP * vd)


def mma_smem_bytes(hd: int, vd: int, rep: int, stages: int, b: int) -> int:
    """Shared memory of one tma_mma block (``mm::smem_bytes``): slack to
    align the ring to 1 KB, the ring of 64-key K and V tiles and 16-head q
    tiles in 64-column boxes, the warps' partial sums, the barriers and
    the live list."""
    hdp, vdp = (64 if d <= 64 else 128 for d in (hd, vd))
    stage = (hdp + vdp) // 64 * MMA_TILE * 128 + hdp // 64 * 16 * 128
    rows = 8 if rep <= 8 else 16
    return (1024 + stages * stage + 8 * rows * (vdp + 8 + 2) * 4 + 16 * 10 * 4
            + 2 * stages * 8 + (2 * b + 2) * 4)


def _mma_refusal(b: int, h: int, hkv: int, hd: int, vd: int,
                 q_dtype: torch.dtype, kv_dtype: torch.dtype) -> str:
    """Why tma_mma does not take a call ("" if it does)."""
    if q_dtype != torch.bfloat16 or kv_dtype != torch.bfloat16:
        return f"it takes bf16 q and cache, not {q_dtype} / {kv_dtype}"
    if hd % 16 or vd % 16 or max(hd, vd) > MMA_MAX_DIM:
        return (f"it takes hd and vd multiples of 16 up to {MMA_MAX_DIM}, "
                f"not {hd} / {vd}")
    if h // hkv > MMA_MAX_REP:
        return f"it takes up to {MMA_MAX_REP} query heads per kv head"
    if b > MMA_MAX_SLOTS:
        return f"it takes up to {MMA_MAX_SLOTS} slots"
    if mma_smem_bytes(hd, vd, h // hkv, MMA_MIN_STAGES, b) > MAX_SMEM:
        return f"{MMA_MIN_STAGES} ring stages need more shared memory"
    return ""


@functools.lru_cache(maxsize=256)
def plan(b: int, h: int, hkv: int, cap: int, hd: int, vd: int,
         q_dtype: torch.dtype, kv_dtype: torch.dtype, n_sm: int, *,
         variant: Optional[str] = None) -> Plan:
    """The plan of a call with q (b, 1, h, hd) of ``q_dtype`` and a cache
    k (b, cap, hkv, hd), v (b, cap, hkv, vd) of ``kv_dtype`` on a card
    with ``n_sm`` SMs (cached: serving asks for one shape per layer).
    ``variant`` forces another variant than the plan's own (for
    measurements); raises where the kernel does not take the call."""
    if min(b, h, hkv, cap, hd, vd, n_sm) < 1 or h % hkv:
        raise ValueError(f"flash_decode B={b} H={h} Hkv={hkv} C={cap} "
                         f"hd={hd} vd={vd}: need positive sizes and "
                         f"H % Hkv == 0")
    if q_dtype not in _DTYPES or kv_dtype not in _DTYPES:
        raise ValueError(f"dtypes q={q_dtype} cache={kv_dtype}: the kernel "
                         f"takes f32/bf16 q and an f32/bf16 cache")
    esz = 2 if kv_dtype == torch.bfloat16 else 4
    if (hd * esz) % 16 or (vd * esz) % 16:
        raise ValueError(f"cache rows must be whole 16-byte vectors "
                         f"(hd={hd}, vd={vd}, {kv_dtype})")
    refusal = _mma_refusal(b, h, hkv, hd, vd, q_dtype, kv_dtype)
    if variant is None:
        variant = "fma" if refusal else "tma_mma"
    elif variant not in _VARIANTS:
        raise ValueError(f"unknown flash_decode variant {variant!r}")
    elif variant == "tma_mma" and refusal:
        raise ValueError(f"variant tma_mma does not take B={b} H={h} "
                         f"Hkv={hkv} hd={hd} vd={vd}: {refusal}")
    rep = h // hkv
    if variant == "tma_mma":
        chunk = mma_chunk(b, hkv, cap, n_sm)
        nchunk = _cdiv(cap, chunk)
        base = mma_smem_bytes(hd, vd, rep, 0, b)
        per_stage = mma_smem_bytes(hd, vd, rep, 1, b) - base
        stages = min(MMA_MAX_STAGES, (MAX_SMEM - base) // per_stage)
        return Plan(variant, chunk, nchunk,
                    (min(n_sm, b * hkv * nchunk), 1, 1), stages,
                    base + stages * per_stage)
    if vd * esz // 16 > THREADS:
        raise ValueError(f"vd={vd} is wider than one block's columns "
                         f"({THREADS * 16 // esz} for {kv_dtype})")
    smem = fma_smem_bytes(hd, vd, kv_dtype)
    if smem > MAX_SMEM:
        raise ValueError(f"hd={hd}, vd={vd} need more shared memory than "
                         f"a block has")
    chunk, nsplit = split_plan(b, h, hkv, cap, n_sm)
    return Plan("fma", chunk, nsplit,
                (nsplit, hkv * _cdiv(rep, FMA_MAX_REP), b), 1, smem)


def live_chunks(valid: Sequence[int], cap: int, chunk: int
                ) -> List[Tuple[int, int]]:
    """The live (slot, chunk) pairs of tma_mma's work list, in list order:
    slot b has ceil(min(max(valid[b], 0), cap) / chunk) live chunks. Item
    ``it`` of the kernel's list is pair ``it // Hkv`` at kv head ``it %
    Hkv``; block x takes items x, x + grid, ... The kernel spells the same
    arithmetic on the card (``item_at``)."""
    pairs = []
    for b, n in enumerate(valid):
        live = min(max(int(n), 0), cap)
        pairs.extend((b, c) for c in range(_cdiv(live, chunk)))
    return pairs


@functools.lru_cache(maxsize=16)
def sm_count(device: torch.device) -> int:
    """SMs of a CUDA device (cached per device)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def _library():
    """The kernel library, its C functions typed, building on first use."""
    if not _BOUND:
        lib = build.load("flash_decode")
        i, p = ctypes.c_int, ctypes.c_void_p
        launch = lib.flash_decode_launch
        launch.argtypes = ([i] + [p] * 8 + [i] * 10
                           + [ctypes.c_float, i, i, p])
        launch.restype = i
        lib.flash_decode_smem_bytes.argtypes = [i] * 7
        lib.flash_decode_smem_bytes.restype = i
        _BOUND["lib"] = lib
    return _BOUND["lib"]


def library_smem_bytes(p: Plan, b: int, h: int, hkv: int, hd: int, vd: int,
                       kv_dtype: torch.dtype) -> int:
    """What the C interface says plan ``p`` needs (for a check against
    ``p.smem``, which mirrors it)."""
    return _library().flash_decode_smem_bytes(
        _VARIANTS[p.variant], hd, vd, int(kv_dtype == torch.bfloat16),
        h // hkv, p.stages, b)


def _cached(store: dict, device: torch.device, n: int,
            dtype: torch.dtype) -> torch.Tensor:
    """A zeroed buffer of at least ``n`` elements kept per device, grown
    (zeroed anew) when a call needs more."""
    buf = store.get(device)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 2 * (0 if buf is None else buf.numel())),
                          dtype=dtype, device=device)
        store[device] = buf
    return buf


def run_plan(p: Plan, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             kv_valid_len: torch.Tensor, scale: float) -> torch.Tensor:
    """One call of plan ``p`` (from ``plan`` at these shapes) on checked
    CUDA tensors, counted nowhere; returns the (B, 1, H, vd) output."""
    b, _, h, hd = q.shape
    cap, hkv, vd = k.shape[1], k.shape[2], v.shape[3]
    out = torch.empty((b, 1, h, vd), dtype=v.dtype, device=q.device)
    # ws_acc starts 16-byte aligned after ws_ml
    n_ml, n_acc = round_up(b * h * p.nchunk * 2, 4), b * h * p.nchunk * vd
    if p.variant == "tma_mma":
        # kept between calls: partials need no clearing, and the kernel
        # leaves every count it uses at 0
        ws = _cached(_WORKSPACE, q.device, n_ml + n_acc, torch.float32)
        counters = _cached(_COUNTERS, q.device, b * hkv, torch.int32)
    else:
        ws = torch.empty(n_ml + n_acc, dtype=torch.float32, device=q.device)
        counters = ws       # unused by fma
    ws_ml, ws_acc = ws.data_ptr(), ws.data_ptr() + 4 * n_ml
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _library().flash_decode_launch(
            _VARIANTS[p.variant], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            kv_valid_len.data_ptr(), out.data_ptr(), ws_acc, ws_ml,
            counters.data_ptr(), b, h, hkv, cap, hd, vd, p.chunk, p.nchunk,
            p.grid[0], p.stages, scale, _DTYPES[q.dtype], _DTYPES[k.dtype],
            stream)
    if err != 0:
        raise RuntimeError(f"flash_decode kernel launch failed: CUDA error "
                           f"{err} (B={b} H={h} Hkv={hkv} C={cap} hd={hd} "
                           f"vd={vd} {q.dtype}/{k.dtype} {p})")
    return out


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
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    p = plan(b, h, hkv, cap, hd, vd, q.dtype, k.dtype, sm_count(q.device))
    out = run_plan(p, q, k, v, kv_valid_len, scale)
    flash_decode_bhrd.launches += 1
    flash_decode_bhrd.variants[p.variant] += 1
    return out


def reset_counts() -> None:
    """Zero the counts: ``launches`` (wrapper calls that launched the
    kernel, one per layer per decode step) and ``variants`` (those calls
    by variant)."""
    flash_decode_bhrd.launches = 0
    flash_decode_bhrd.variants = collections.Counter()


reset_counts()
