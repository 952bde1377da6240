"""Wrapper of the Hopper batched expert SwiGLU kernel
(``csrc/moe_ffn.cu``): ``(silu(buf @ wg) * (buf @ wu)) @ wd`` per expert
over (E, C, d) capacity buffers.

Replaces the TPU kernel ``moe_expert_ffn_ecd`` of the JAX package. A call
runs two passes on the current stream: the gate·up product with the
SwiGLU taken in its epilogue into an (E, C, ff) hidden, then the down
product. What bounds it: operations (128.8 GFLOP on 268 MB at granite's
training shape, E 32 C 1280 d 1024 ff 512).

An optional ``fill`` ((E,) int32 on the card) says how many rows of each
expert are live: rows at or past ``fill[e]`` give zeros, and the kernel
skips the tiles that lie wholly past them. ``moe_block`` fills each
expert's buffer from row 0 on and passes its counts, so on that path the
output is the same with and without it.

``plan`` decides everything about a call on the host from shapes and
dtype alone and is pure, so the CPU tests hold it at every MoE config.
Its variant, never because something failed:

* ``wgmma`` (bf16): both passes on warpgroup MMA fed by a TMA ring
  through 3-D tensor maps (one per operand, so a ragged tile zero-fills
  inside its own expert); pass 1 takes 128 x 128 tiles of the hidden
  with gate and up in one accumulator, pass 2 128 x ``block_n`` tiles of
  the output (256 or 128 by waves), each tile stored by TMA from shared
  memory; two CUDA kernels a call. d and ff are zero-padded to multiples
  of 8 where they are not (TMA's 16-byte rows; no MoE config is ragged),
  and the output is sliced back;
* ``mma_sync`` (bf16): the first design (mma.sync fed by a cp.async
  ring, ragged edges masked in the kernel). The wrapper never picks it;
  ``run_plan(plan(..., variant="mma_sync"), ...)`` runs it, so a
  measurement can time it beside ``wgmma`` on the same inputs;
* ``fma`` (f32): CUDA-core FMA, the first design's f32 kernel.

The wrapper checks device, dtypes, shapes, contiguity and alignment and
raises on what the kernel does not take; it allocates the output, the
hidden (``torch.empty``: pass 2 never reads the hidden of a skipped tile)
and any padding, launches, raises if the launch reports an error, and per
call adds one to ``moe_expert_ffn_ecd.launches``, one to
``moe_expert_ffn_ecd.variants[variant]``, and one to ``.filled`` and
``.padded`` where it took a fill or padded.

The kernels are built at the first call (``repro_torch.kernels.build``),
never at import. There is no CPU path here: ``dispatch`` gives CPU
tensors to the plain version.
"""
from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.common import round_up
from repro_torch.kernels.lora_matmul import SMS, WIDE_TILE_COST

#: variant codes of the C interface (``kFma``, ``kMmaSync``, ``kWgmma``)
_VARIANTS = {"fma": 0, "mma_sync": 1, "wgmma": 2}
_DTYPES = {"fma": torch.float32, "mma_sync": torch.bfloat16,
           "wgmma": torch.bfloat16}
#: dynamic shared memory of one block (bytes): wgmma's 192 KB ring of
#: 4 stages of 48 KB (6 of 32 KB at block_n 128), its barriers and 1 KB
#: of alignment slack (``wg::smem_bytes``); mma_sync's and fma's 3-stage
#: rings (``tc::SMEM``, ``fp::SMEM``)
WGMMA_SMEM = {256: 4 * 49152 + 2 * 8 * 4 + 1024,
              128: 6 * 32768 + 2 * 8 * 6 + 1024}
MMA_SYNC_SMEM = 3 * (128 * 72 + 64 * 136) * 2
FMA_SMEM = 3 * (64 * 20 + 16 * 68) * 4
#: shared memory a block may use on Hopper (bytes)
MAX_SMEM = 227 * 1024
_BOUND: dict = {}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one call runs. ``variant``: ``wgmma``, ``mma_sync`` or ``fma``.
    ``d_pad``, ``ff_pad``: d and ff after zero padding (wgmma: multiples
    of 8; the others mask ragged edges and pad nothing). ``block_m``:
    rows of a tile in both passes. ``width``: columns of a pass-1 tile of
    the hidden; ``block_n``: of a pass-2 tile of the output. ``grid1``,
    ``grid2``: the passes' (x, y, z) blocks (wgmma: one flat axis,
    expert-major). ``smem1``, ``smem2``: dynamic shared memory per block
    (bytes). ``padded``: whether d or ff was padded."""
    variant: str
    d_pad: int
    ff_pad: int
    block_m: int
    width: int
    block_n: int
    grid1: Tuple[int, int, int]
    grid2: Tuple[int, int, int]
    smem1: int
    smem2: int
    padded: bool


def _block_n(row_tiles: int, d_pad: int) -> int:
    """Pass 2's tile width: 256 unless its fewer, longer waves of blocks
    cost more than 128's (``lora_matmul``'s rule and measured cost)."""
    waves = {bn: _cdiv(row_tiles * _cdiv(d_pad, bn), SMS) for bn in (128, 256)}
    return 256 if waves[256] * WIDE_TILE_COST < waves[128] else 128


@functools.lru_cache(maxsize=256)
def plan(e: int, c: int, d: int, ff: int, dtype: torch.dtype, *,
         variant: Optional[str] = None) -> Plan:
    """The plan of a call with buf (e, c, d), wg/wu (e, d, ff), wd (e, ff,
    d) of ``dtype`` (cached: a training path asks for one shape per
    layer). ``variant`` forces another variant than the plan's own (for
    measurements); raises where it does not take the dtype."""
    if min(e, c, d, ff) < 1:
        raise ValueError(f"empty moe_expert_ffn E={e} C={c} d={d} ff={ff}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the moe_expert_ffn kernel takes f32 or bf16, "
                         f"got {dtype}")
    own = "wgmma" if dtype == torch.bfloat16 else "fma"
    variant = variant or own
    if variant not in _VARIANTS:
        raise ValueError(f"unknown moe_expert_ffn variant {variant!r}")
    if _DTYPES[variant] != dtype:
        raise ValueError(f"variant {variant} takes {_DTYPES[variant]}, not "
                         f"{dtype}")
    if variant == "wgmma":
        d_pad, ff_pad = round_up(d, 8), round_up(ff, 8)
        row_tiles = e * _cdiv(c, 128)
        block_n = _block_n(row_tiles, d_pad)
        return Plan("wgmma", d_pad, ff_pad, 128, 128, block_n,
                    (row_tiles * _cdiv(ff_pad, 128), 1, 1),
                    (row_tiles * _cdiv(d_pad, block_n), 1, 1),
                    WGMMA_SMEM[256], WGMMA_SMEM[block_n],
                    padded=(d_pad, ff_pad) != (d, ff))
    bm, width, bn, smem = ((128, 64, 128, MMA_SYNC_SMEM)
                           if variant == "mma_sync" else (64, 32, 64, FMA_SMEM))
    return Plan(variant, d, ff, bm, width, bn,
                (_cdiv(ff, width), _cdiv(c, bm), e),
                (_cdiv(d, bn), _cdiv(c, bm), e), smem, smem, padded=False)


def live_tiles(p: Plan, c: int, fill: Optional[Sequence[int]]
               ) -> Tuple[int, int]:
    """(pass-1 tiles, pass-2 tiles) that run their products under plan
    ``p`` with capacity ``c`` and the per-expert ``fill`` (None: every
    row). The others are skipped (pass 1) or store zeros (pass 2)."""
    if fill is None:
        return math.prod(p.grid1), math.prod(p.grid2)
    live = sum(_cdiv(min(max(int(f), 0), c), p.block_m) for f in fill)
    return (live * _cdiv(p.ff_pad, p.width), live * _cdiv(p.d_pad, p.block_n))


def _launch_fn():
    if not _BOUND:
        fn = build.load("moe_ffn").moe_ffn_launch
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 7 + [i] * 7 + [vp]
        fn.restype = i
        _BOUND["launch"] = fn
    return _BOUND["launch"]


def pad_operands(p: Plan, buf: torch.Tensor, wg: torch.Tensor,
                 wu: torch.Tensor, wd: torch.Tensor):
    """buf, wg, wu and wd zero-padded to d_pad and ff_pad as ``p`` says
    (unchanged where it says nothing)."""
    d, ff = wg.shape[1], wg.shape[2]
    if p.d_pad != d:
        dp = p.d_pad - d
        buf, wd = F.pad(buf, (0, dp)), F.pad(wd, (0, dp))
        wg, wu = F.pad(wg, (0, 0, 0, dp)), F.pad(wu, (0, 0, 0, dp))
    if p.ff_pad != ff:
        fp = p.ff_pad - ff
        wg, wu = F.pad(wg, (0, fp)), F.pad(wu, (0, fp))
        wd = F.pad(wd, (0, 0, 0, fp))
    return buf, wg, wu, wd


def run_plan(p: Plan, buf: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
             wd: torch.Tensor, fill: Optional[torch.Tensor] = None
             ) -> torch.Tensor:
    """Both passes of one call under plan ``p``, counted nowhere (the
    wrapper counts; a measurement may time ``mma_sync`` with it);
    (E, C, d) out, a view of the padded output where d was padded."""
    e, c, d = buf.shape
    buf, wg, wu, wd = pad_operands(p, buf, wg, wu, wd)
    out = torch.empty((e, c, p.d_pad), dtype=buf.dtype, device=buf.device)
    hidden = torch.empty((e, c, p.ff_pad), dtype=buf.dtype, device=buf.device)
    tensors = (buf, wg, wu, wd)
    per_vec = 16 // buf.element_size()
    vec = int(p.d_pad % per_vec == 0 and p.ff_pad % per_vec == 0
              and all(t.data_ptr() % 16 == 0 for t in tensors))
    with torch.cuda.device(buf.device):
        stream = torch.cuda.current_stream(buf.device).cuda_stream
        err = _launch_fn()(
            buf.data_ptr(), wg.data_ptr(), wu.data_ptr(), wd.data_ptr(),
            hidden.data_ptr(), out.data_ptr(),
            None if fill is None else fill.data_ptr(), e, c, p.d_pad,
            p.ff_pad, _VARIANTS[p.variant], vec, p.block_n, stream)
    if err != 0:
        raise RuntimeError(f"moe_expert_ffn kernel launch failed: CUDA error "
                           f"{err} (E={e} C={c} d={d} {buf.dtype} {p})")
    return out if p.d_pad == d else out[..., :d]


def moe_expert_ffn_ecd(buf: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                       wd: torch.Tensor, *,
                       fill: Optional[torch.Tensor] = None) -> torch.Tensor:
    """buf: (E, C, d); wg, wu: (E, d, ff); wd: (E, ff, d), one dtype (f32
    or bf16), contiguous, on one CUDA device (bf16: 16-byte aligned).
    ``fill``: None, or (E,) int32 on the same device, expert e's rows at
    or past ``fill[e]`` giving zeros. Returns (E, C, d) in ``buf.dtype``:
    f32 accumulation, one rounding at the end (in bf16 the hidden is
    rounded to bf16 for the tensor cores)."""
    tensors = (buf, wg, wu, wd)
    if buf.device.type != "cuda":
        raise ValueError(f"the Hopper moe_expert_ffn kernel takes CUDA "
                         f"tensors, got {buf.device}")
    if not all(t.device == buf.device for t in tensors):
        raise ValueError("buf, wg, wu and wd must share one device")
    if buf.dtype not in (torch.float32, torch.bfloat16) or not all(
            t.dtype == buf.dtype for t in tensors):
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
    if buf.dtype == torch.bfloat16 and any(t.data_ptr() % 16
                                           for t in tensors):
        raise ValueError("bf16 buf, wg, wu and wd must start at 16-byte "
                         "aligned addresses")
    if fill is not None and (fill.dtype != torch.int32
                             or tuple(fill.shape) != (e,)
                             or fill.device != buf.device
                             or not fill.is_contiguous()):
        raise ValueError(f"fill must be a contiguous (E,) = ({e},) int32 "
                         f"tensor on {buf.device}, got {fill.dtype}"
                         f"{tuple(fill.shape)} on {fill.device}")
    if buf.numel() == 0 or ff == 0:
        return torch.zeros_like(buf)
    p = plan(e, c, d, ff, buf.dtype)
    out = run_plan(p, buf, wg, wu, wd, fill)
    moe_expert_ffn_ecd.launches += 1
    moe_expert_ffn_ecd.variants[p.variant] += 1
    moe_expert_ffn_ecd.filled += int(fill is not None)
    moe_expert_ffn_ecd.padded += int(p.padded)
    return out


def reset_counts() -> None:
    """Zero the counts: ``launches`` (wrapper calls that launched both
    passes), ``variants`` (those calls by variant), ``filled`` (those
    that took a fill) and ``padded`` (those that zero-padded d or ff)."""
    moe_expert_ffn_ecd.launches = 0
    moe_expert_ffn_ecd.variants = collections.Counter()
    moe_expert_ffn_ecd.filled = 0
    moe_expert_ffn_ecd.padded = 0


reset_counts()
