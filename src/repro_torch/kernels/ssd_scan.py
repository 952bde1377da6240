"""Wrapper of the Hopper Mamba-2 chunked SSD forward kernel
(``csrc/ssd_scan.cu``), in model layout.

Replaces the TPU kernel ``ssd_scan`` of the JAX package. x, b and c are
read in place through their strides (on the model path they are slices
of the conv output, so they are not contiguous); only their last axis
must be dense. b and c stay per group: the kernel indexes group
``h // (H / G)`` and nothing is repeated to H heads in memory.

``plan`` decides everything about a call on the host from shapes, dtype
and alignment alone and is pure, so the CPU tests hold it at every
Mamba config. Its variant, never because something failed:

* ``mma`` (bf16 x/b/c; P and N multiples of 16 with P <= 64, N <= 128;
  chunk <= 256; base addresses and row strides of x, b and c 16-byte
  aligned, as TMA needs): one block per chunk of ``hpb`` heads of one
  group (``heads_per_block``: they share one load of b and c), the
  chunk's tiles by TMA kept in shared memory, every product on wgmma
  tensor cores with each f32 operand (the weights, the state, x dt decay)
  split into bf16 high and low parts (``split_hi_lo`` spells the split),
  the state carried from chunk to chunk by a look-back: each block takes
  a ticket (``chunk_order`` spells the map), waits on the flag of each
  head's previous chunk, and publishes the state leaving its chunk in a
  workspace. The workspace and the flags are cached per device and kept
  between calls, so two calls on two streams at once are not supported
  (training runs on one stream);
* ``fma`` (f32, and any shape or layout ``mma`` does not take): the first
  design, one block per (batch, head) over its chunks in order, CUDA-core
  f32 FMA.

``run_plan`` launches one plan uncounted, so a measurement can time the
``fma`` design on inputs the wrapper gives to ``mma``; ``ssd_scan_bshp``
never forces a variant. The wrapper checks device, dtypes, shapes and
strides and raises on what the kernel does not take; it allocates the
output, launches on the current stream, raises if the launch reports an
error, and per call adds one to ``ssd_scan_bshp.launches`` and one to
``ssd_scan_bshp.variants[variant]``.

The kernel is built at the first call (``repro_torch.kernels.build``),
never at import. There is no CPU path here: ``dispatch`` gives CPU
tensors to the plain version.
"""
from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
from typing import List, Optional, Tuple

import torch

from repro_torch.kernels import build

#: limits of both variants
MAX_HEAD_DIM = 64
MAX_STATE = 128
MAX_CHUNK = 512
#: rows of a query or key tile of mma (``mm::T``)
MMA_TILE = 64
#: tiles of a chunk mma keeps resident (``mm::MAX_TILES``): chunk <= 256
MMA_MAX_TILES = 4
#: most heads an mma block takes
MMA_MAX_HPB = 16
#: shared memory a block may use on Hopper (bytes)
MAX_SMEM = 227 * 1024

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: variant codes of the C interface
_VARIANTS = {"fma": 0, "mma": 1}
#: shared memory of one fma block (``kSmemBytes``)
FMA_SMEM = 4 * (MAX_STATE * MAX_HEAD_DIM + 2 * MAX_STATE * (MMA_TILE + 4)
                + MMA_TILE * (MAX_HEAD_DIM + 4) + MMA_TILE * (MMA_TILE + 4)
                + 3 * MAX_CHUNK)
_BOUND: dict = {}
#: mma's workspace and its int32 counter + flags, per device
_WORKSPACE: dict = {}
_FLAGS: dict = {}
#: the last epoch (flag value) used on each device
_EPOCH: dict = {}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one call runs. ``variant``: ``mma`` or ``fma``. ``chunk``: rows
    of a chunk (capped at S); ``nc`` = ceil(S / chunk). ``grid``: blocks
    (one per (batch, head, chunk) for mma, per (batch, head) for fma).
    ``tiles``: the 64-row tiles of a chunk that an mma block holds in
    shared memory (0 for fma). ``hpb``: heads an mma block takes, of one
    group (they share b and c; 1 for fma). ``smem``: dynamic shared memory
    per block (bytes). ``workspace``: bytes of mma's state workspace, B H
    (nc - 1) P N f32 (0 for fma). ``waves``: the grid over the blocks the
    card holds at once (one an SM)."""
    variant: str
    chunk: int
    nc: int
    grid: int
    tiles: int
    hpb: int
    smem: int
    workspace: int
    waves: float


def mma_smem_bytes(n: int, tiles: int) -> int:
    """Shared memory of one mma block (``mm::smem_bytes``): slack to align
    to 1 KB, the chunk's b tiles, two buffers of a head's x tiles, the c
    tiles in 64-column boxes (their place, at least four boxes a 64
    columns of N, later holds the f32 increment and the state's high and
    low parts), cum / dt / decay, three barriers and the ticket."""
    nb = 1 if n <= 64 else 2
    box = MMA_TILE * 128
    return (1024 + tiles * nb * box + 2 * tiles * box + max(tiles, 4) * nb * box
            + 3 * MMA_MAX_TILES * MMA_TILE * 4 + 3 * 8 + 8)



def heads_per_block(bsz: int, h: int, g: int, nc: int, n_sm: int) -> int:
    """Heads of one group an mma block takes: the divisor k of H / G (up
    to MMA_MAX_HPB) that minimises ceil(B (H / k) nc / n_sm) k, the heads
    the busiest SM runs at one block an SM; the largest such k, since the
    heads of a block share one load of b and c and a block that waits for
    its predecessor waits once."""
    ks = [k for k in range(1, MMA_MAX_HPB + 1) if (h // g) % k == 0]
    return min(ks, key=lambda k: (_cdiv(bsz * (h // k) * nc, n_sm) * k, -k))


def _mma_refusal(p: int, n: int, chunk: int, dtype: torch.dtype,
                 aligned: bool) -> str:
    """Why mma does not take a call ("" if it does)."""
    if dtype != torch.bfloat16:
        return f"it takes bf16 x, b and c, not {dtype}"
    if p % 16 or n % 16:
        return f"it takes P and N multiples of 16, not {p} / {n}"
    if chunk > MMA_MAX_TILES * MMA_TILE:
        return (f"it keeps a chunk's tiles in shared memory: chunk <= "
                f"{MMA_MAX_TILES * MMA_TILE}, not {chunk}")
    if not aligned:
        return ("TMA needs 16-byte aligned base addresses and row strides "
                "of x, b and c")
    return ""


@functools.lru_cache(maxsize=256)
def plan(bsz: int, s: int, h: int, p: int, g: int, n: int, chunk: int,
         dtype: torch.dtype, n_sm: int, aligned: bool = True, *,
         variant: Optional[str] = None) -> Plan:
    """The plan of a call with x (bsz, s, h, p), b/c (bsz, s, g, n) of
    ``dtype`` at chunk ``chunk`` on a card with ``n_sm`` SMs; ``aligned``:
    whether x, b and c start and step on 16-byte boundaries (``aligned``
    below). Cached: a training path asks for one shape per layer.
    ``variant`` forces another variant than the plan's own (for
    measurements); raises where the kernel does not take the call."""
    if min(bsz, s, h, p, g, n, chunk, n_sm) < 1 or h % g:
        raise ValueError(f"ssd_scan B={bsz} S={s} H={h} P={p} G={g} N={n} "
                         f"chunk={chunk}: need positive sizes and H % G "
                         f"== 0")
    if dtype not in _DTYPES:
        raise ValueError(f"the ssd_scan kernel takes f32 or bf16, got {dtype}")
    chunk = min(chunk, s)
    if p > MAX_HEAD_DIM or n > MAX_STATE or chunk > MAX_CHUNK:
        raise ValueError(f"P={p} N={n} chunk={chunk}: the kernel takes P <= "
                         f"{MAX_HEAD_DIM}, N <= {MAX_STATE}, chunk <= "
                         f"{MAX_CHUNK}")
    refusal = _mma_refusal(p, n, chunk, dtype, aligned)
    if variant is None:
        variant = "fma" if refusal else "mma"
    elif variant not in _VARIANTS:
        raise ValueError(f"unknown ssd_scan variant {variant!r}")
    elif variant == "mma" and refusal:
        raise ValueError(f"variant mma does not take P={p} N={n} "
                         f"chunk={chunk} {dtype}: {refusal}")
    nc = _cdiv(s, chunk)
    if variant == "mma":
        tiles = _cdiv(chunk, MMA_TILE)
        hpb = heads_per_block(bsz, h, g, nc, n_sm)
        grid = bsz * (h // hpb) * nc
        return Plan("mma", chunk, nc, grid, tiles, hpb,
                    mma_smem_bytes(n, tiles), 4 * bsz * h * (nc - 1) * p * n,
                    grid / n_sm)
    return Plan("fma", chunk, nc, bsz * h, 0, 1, FMA_SMEM, 0,
                bsz * h / n_sm)


def aligned(*tensors: torch.Tensor) -> bool:
    """Whether each tensor's base address and every stride but the last
    (dense) one are positive whole 16-byte steps, as a TMA map needs."""
    for t in tensors:
        esz = t.element_size()
        if t.data_ptr() % 16:
            return False
        if any(st < 1 or (st * esz) % 16 for st in t.stride()[:-1]):
            return False
    return True


def chunk_order(bsz: int, h: int, nc: int, hpb: int
                ) -> List[Tuple[int, int, int]]:
    """The (batch, first head, chunk) that each ticket of mma's look-back
    names, in ticket order; a ticket takes heads first .. first + hpb - 1.
    Chunk slowest: every block of chunk ci - 1 holds an earlier ticket
    than any of chunk ci, so a block's predecessor is running or done (no
    wait can deadlock) and, on a grid of several waves, usually done. The
    kernel spells the same map on the card."""
    rows = bsz * (h // hpb)
    return [(t % rows // (h // hpb), t % rows % (h // hpb) * hpb, t // rows)
            for t in range(rows * nc)]


def split_hi_lo(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The bf16 high part of f32 ``t`` and the bf16 rounding of what is
    left: hi + lo holds t to ~2**-17 of each element, so two bf16 mmas
    with f32 accumulation give an f32-precision product (``split_scaled``
    and the state's split in the kernel)."""
    hi = t.float().to(torch.bfloat16)
    return hi, (t.float() - hi.float()).to(torch.bfloat16)


@functools.lru_cache(maxsize=16)
def sm_count(device: torch.device) -> int:
    """SMs of a CUDA device (cached per device)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def _library():
    """The kernel library, its C functions typed, building on first use."""
    if not _BOUND:
        lib = build.load("ssd_scan")
        i, p, ll = ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong
        launch = lib.ssd_scan_launch
        launch.argtypes = ([i] + [p] * 9 + [i] * 9 + [ll] * 12 + [i, p])
        launch.restype = i
        lib.ssd_scan_smem_bytes.argtypes = [i] * 3
        lib.ssd_scan_smem_bytes.restype = i
        _BOUND["lib"] = lib
    return _BOUND["lib"]


def library_smem_bytes(pl: Plan, n: int) -> int:
    """What the C interface says plan ``pl`` needs (for a check against
    ``pl.smem``, which mirrors it)."""
    return _library().ssd_scan_smem_bytes(
        _VARIANTS[pl.variant], 1 if n <= 64 else 2, pl.tiles)


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


def _next_epoch(device: torch.device) -> int:
    """A flag value no slot holds yet on ``device``: one more than the
    last call's, never 0 (a fresh buffer's flags)."""
    epoch = _EPOCH.get(device, 0) % (2**31 - 1) + 1
    _EPOCH[device] = epoch
    return epoch


def run_plan(pl: Plan, x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """One call of plan ``pl`` (from ``plan`` at these shapes) on checked
    CUDA tensors, counted nowhere; returns y (B, S, H, P) in x's dtype."""
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    y = torch.empty((bsz, s, h, p), dtype=x.dtype, device=x.device)
    if pl.variant == "mma":
        # kept between calls: the state needs no clearing, the counter
        # ends every call at 0 and each call's flags carry a new epoch
        ws = _cached(_WORKSPACE, x.device, max(1, pl.workspace // 4),
                     torch.float32)
        flags = _cached(_FLAGS, x.device, 1 + bsz * h * (pl.nc - 1),
                        torch.int32)
        epoch = _next_epoch(x.device)
    else:
        ws = flags = y      # unused by fma
        epoch = 0
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _library().ssd_scan_launch(
            _VARIANTS[pl.variant], x.data_ptr(), dt.data_ptr(), a.data_ptr(),
            b.data_ptr(), c.data_ptr(), d.data_ptr(), y.data_ptr(),
            ws.data_ptr(), flags.data_ptr(), epoch, pl.hpb, bsz, s, h, p, g,
            n, pl.chunk, *x.stride()[:3], *dt.stride(),
            *b.stride()[:3], *c.stride()[:3], _DTYPES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {err} "
                           f"(B={bsz} S={s} H={h} P={p} G={g} N={n} "
                           f"{x.dtype} {pl})")
    return y


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
    if (tuple(dt.shape) != (bsz, s, h) or tuple(b.shape) != (bsz, s, g, n)
            or c.shape != b.shape or tuple(a.shape) != (h,)
            or tuple(d.shape) != (h,) or h % g):
        raise ValueError(f"shapes x={tuple(x.shape)} dt={tuple(dt.shape)} "
                         f"a={tuple(a.shape)} b={tuple(b.shape)} "
                         f"c={tuple(c.shape)} d={tuple(d.shape)} disagree")
    if x.stride(3) != 1 or b.stride(3) != 1 or c.stride(3) != 1:
        raise ValueError("x, b and c must be dense along their last axis")
    if not (a.is_contiguous() and d.is_contiguous()):
        raise ValueError("a and d must be contiguous")
    if x.numel() == 0:
        return torch.empty((bsz, s, h, p), dtype=x.dtype, device=x.device)
    pl = plan(bsz, s, h, p, g, n, int(chunk), x.dtype, sm_count(x.device),
              aligned(x, b, c))
    y = run_plan(pl, x, dt, a, b, c, d)
    ssd_scan_bshp.launches += 1
    ssd_scan_bshp.variants[pl.variant] += 1
    return y


def reset_counts() -> None:
    """Zero the counts: ``launches`` (wrapper calls that launched the
    kernel, one per Mamba layer per forward) and ``variants`` (those calls
    by variant)."""
    ssd_scan_bshp.launches = 0
    ssd_scan_bshp.variants = collections.Counter()


reset_counts()
