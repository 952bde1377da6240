"""Wrapper of the Hopper fused frozen-weight + LoRA matmul kernel
(``csrc/lora_matmul.cu``): ``x @ w + scaling * ((x @ a) @ b)``, any rank,
and of its input gradient ``dx = g @ w.T + scaling * (g @ b.T) @ a.T``.

Replaces the TPU kernel ``lora_matmul`` of the JAX package. A call runs
two kernels on the current stream: the pre-pass ``xa = round(x @ a)``
into an (M, r_pad) scratch, then the main kernel, one GEMM over the depth
``[r_pad | K]`` whose first steps are the rank product (see the source).
``plan`` decides everything about a call on the host — variant, r_pad,
padding, grids — and is pure, so the CPU tests hold it at every path
shape; ``pad_operands``, ``prepass`` and ``run_plan`` let a measurement
time the pre-pass alone and another tile width.

The wrapper flattens the leading dims of ``x``, checks dtypes, shapes,
device, contiguity and alignment and raises on anything the kernel does
not take; it allocates the scratch, any padding and the output with
``torch.empty``/``pad``, launches, and raises if either launch reports an
error. Per call it adds one to ``lora_matmul_fused.launches``, one to
``lora_matmul_fused.variants[variant]`` and, where it padded, one to
``lora_matmul_fused.padded``.

The input gradient (bf16 only; replaces no TPU kernel: the JAX package
differentiates the plain version) has its own entry, ``lora_matmul_bwd``,
which ``ops.lora_matmul``'s backward calls for bf16 on the card, apart
from the registry's ``lora_matmul``. Its two kernels: a pre-pass g_xa =
scaling * g @ b.T in f32, written as f32 and as three bf16 terms that sum
to it exactly, then the main kernel over the depth ``[3 r_pad | N]``
(``plan_bwd``, ``pad_bwd_operands`` and ``prepass_bwd`` as for the
forward). It counts ``lora_matmul_bwd.launches``,
``.variants`` and ``.padded`` as the forward does; ``.plain`` counts the
backward calls on the card that ran the plain f32 products instead
(``ops``).

The kernels are built at the first call (``repro_torch.kernels.build``),
never at import. There is no CPU path here: ``dispatch`` gives CPU
tensors to the plain version.
"""
from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.common import round_up

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_BOUND: dict = {}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one call runs. ``variant``: ``wgmma`` (bf16: TMA ring and
    warpgroup MMA) or ``fma_f32`` (f32 on CUDA-core FMA). ``r_pad``: the
    width of the x@A scratch, r rounded up to 64. ``k_pad``, ``n_pad``,
    ``r_a``: x's depth, the width of W, B and the output, and A's width
    after zero padding (bf16: multiples of 8, since TMA and the pre-pass
    read rows of whole 16-byte vectors only). ``block_n``: the main
    kernel's tile width. ``grid`` / ``prepass_grid``: the two launches'
    (x, y) blocks. ``padded``: whether any of the three was padded."""
    variant: str
    r_pad: int
    k_pad: int
    n_pad: int
    r_a: int
    block_n: int
    grid: Tuple[int, int]
    prepass_grid: Tuple[int, int]
    padded: bool


#: SMs of an H100 SXM: one main-kernel block runs on each at a time
SMS = 132
#: device time of a 128 x 256 tile over that of a 128 x 128 one, at the
#: same depth (H100, chip_smoke.py's lora_matmul cases): the wider tile
#: does twice the work in 1.6 times the time
WIDE_TILE_COST = 1.6


def _block_n(m: int, n_pad: int) -> int:
    """The main kernel's tile width: 256 unless its fewer, longer waves
    of blocks cost more than 128's (N 512 at M 4096: 64 blocks of 256
    leave half the SMs idle)."""
    waves = {bn: _cdiv(_cdiv(m, 128) * _cdiv(n_pad, bn), SMS)
             for bn in (128, 256)}
    return 256 if waves[256] * WIDE_TILE_COST < waves[128] else 128


#: the main kernel's tile widths each variant instantiates
BLOCK_NS = {"wgmma": (128, 256), "fma_f32": (64,)}


@functools.lru_cache(maxsize=256)
def plan(m: int, k: int, n: int, r: int, dtype: torch.dtype, *,
         block_n: Optional[int] = None) -> Plan:
    """The plan of a call with x (m, k), w (k, n), a (k, r), b (r, n)
    (cached: a training path asks for a few shapes many times).
    ``block_n`` overrides the tile width (the autotuner's knob); raises
    where the variant has no such tile."""
    if min(m, k, n, r) < 1:
        raise ValueError(f"empty lora_matmul M={m} K={k} N={n} r={r}")
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the lora_matmul kernel takes f32 or bf16, got "
                         f"{dtype}")
    variant = "wgmma" if dtype == torch.bfloat16 else "fma_f32"
    if block_n is not None and block_n not in BLOCK_NS[variant]:
        raise ValueError(f"lora_matmul {variant} takes block_n in "
                         f"{BLOCK_NS[variant]}, not {block_n}")
    r_pad = round_up(r, 64)
    if variant == "wgmma":
        k_pad, n_pad, r_a = round_up(k, 8), round_up(n, 8), round_up(r, 8)
        block_n = block_n or _block_n(m, n_pad)
        return Plan("wgmma", r_pad, k_pad, n_pad, r_a, block_n,
                    (_cdiv(m, 128) * _cdiv(n_pad, block_n), 1),
                    (_cdiv(m, 32), r_pad // 64),
                    padded=(k_pad, n_pad, r_a) != (k, n, r))
    return Plan("fma_f32", r_pad, k, n, r, 64,
                (_cdiv(n, 64), _cdiv(m, 64)),
                (r_pad // 64, _cdiv(m, 64)), padded=False)


def knobs(p: Plan) -> dict:
    """The autotuner's knobs of plan ``p``."""
    return {"block_n": p.block_n}


def _lib():
    if not _BOUND:
        lib = build.load("lora_matmul")
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.lora_xa_launch.argtypes = [vp, i, vp, vp] + [i] * 7 + [vp]
        lib.lora_matmul_launch.argtypes = ([vp] * 5 + [i] * 6
                                           + [ctypes.c_float] + [i] * 4
                                           + [vp])
        lib.lora_gxa_launch.argtypes = ([vp] * 4 + [i] * 4 + [ctypes.c_float]
                                        + [i] * 2 + [vp])
        lib.lora_dx_launch.argtypes = [vp] * 5 + [i] * 7 + [vp]
        for fn in (lib.lora_xa_launch, lib.lora_matmul_launch,
                   lib.lora_gxa_launch, lib.lora_dx_launch):
            fn.restype = i
        _BOUND["lib"] = lib
    return _BOUND["lib"]


def _raise_on(err: int, what: str, p: Plan, x2: torch.Tensor, r: int
              ) -> None:
    """Raise if a launch of ``x2`` (M, depth) at rank ``r`` failed."""
    if err != 0:
        raise RuntimeError(f"lora_matmul {what} launch failed: CUDA error "
                           f"{err} (M={x2.shape[0]} depth={x2.shape[1]} "
                           f"r={r} {x2.dtype} {p})")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def pad_operands(p: Plan, x2: torch.Tensor, w: torch.Tensor,
                 a: torch.Tensor, b: torch.Tensor):
    """(M, K) ``x2``, w, a and b zero-padded as ``p`` says (unchanged
    where it says nothing)."""
    k, n = w.shape
    if p.k_pad != k:
        x2 = F.pad(x2, (0, p.k_pad - k))
    if p.n_pad != n:
        w, b = F.pad(w, (0, p.n_pad - n)), F.pad(b, (0, p.n_pad - n))
    if p.r_a != a.shape[1]:
        a = F.pad(a, (0, p.r_a - a.shape[1]))
    return x2, w, a, b


def prepass(p: Plan, x2: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """The pre-pass alone (counted nowhere): xa (M, r_pad) = x @ a,
    rounded to x's dtype, columns past r zero. ``x2`` (M, p.k_pad) and
    ``a`` (K, p.r_a) as ``pad_operands`` gives them, on the current
    device."""
    m, r = x2.shape[0], a.shape[1]
    xa = torch.empty((m, p.r_pad), dtype=x2.dtype, device=x2.device)
    err = _lib().lora_xa_launch(
        x2.data_ptr(), p.k_pad, a.data_ptr(), xa.data_ptr(), m, a.shape[0],
        r, p.r_pad, _DTYPES[x2.dtype], *p.prepass_grid, _stream(x2))
    _raise_on(err, "pre-pass", p, x2, r)
    return xa


def _main(p: Plan, xa: torch.Tensor, x2: torch.Tensor, w: torch.Tensor,
          b: torch.Tensor, scaling: float) -> torch.Tensor:
    """out (M, p.n_pad) = scaling * (xa @ b) + x2 @ w; w and b already
    padded to p.n_pad columns."""
    m, r = x2.shape[0], b.shape[0]
    out = torch.empty((m, p.n_pad), dtype=x2.dtype, device=x2.device)
    err = _lib().lora_matmul_launch(
        xa.data_ptr(), x2.data_ptr(), w.data_ptr(), b.data_ptr(),
        out.data_ptr(), m, p.n_pad, p.k_pad, w.shape[0], r, p.r_pad,
        float(scaling), _DTYPES[x2.dtype], p.block_n, *p.grid, _stream(x2))
    _raise_on(err, "main", p, x2, r)
    return out


def run_plan(p: Plan, x2: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, scaling: float) -> torch.Tensor:
    """Both launches of one call on (M, K) ``x2`` under plan ``p``,
    counted nowhere (the wrapper counts; a measurement may time another
    tile width with it); (M, N) out."""
    n = w.shape[1]
    x2, w, a, b = pad_operands(p, x2, w, a, b)
    with torch.cuda.device(x2.device):
        out = _main(p, prepass(p, x2, a), x2, w, b, scaling)
    return out if p.n_pad == n else out[:, :n]


def lora_matmul_fused(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                      b: torch.Tensor, *, scaling: float = 1.0,
                      block_n: Optional[int] = None) -> torch.Tensor:
    """x: (..., K); w: (K, N); a: (K, r); b: (r, N), all one dtype (f32
    or bf16) on one CUDA device, any r >= 1. ``scaling`` (alpha / r) is a
    Python number, passed by value. ``block_n`` overrides the plan's tile
    width (``plan``). Returns (..., N) in ``x.dtype``."""
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
    if x.shape[-1] != k_dim or a.shape[0] != k_dim or b.shape != (r, n) \
            or r < 1:
        raise ValueError(f"shapes x={tuple(x.shape)} w={tuple(w.shape)} "
                         f"a={tuple(a.shape)} b={tuple(b.shape)} disagree")
    if x.device.type != "cuda":
        raise ValueError(f"the Hopper lora_matmul kernel takes CUDA tensors, "
                         f"got {x.device}")
    if not (x.device == w.device == a.device == b.device):
        raise ValueError("x, w, a and b must share one device")
    if not all(t.is_contiguous() for t in (x, w, a, b)):
        raise ValueError("x, w, a and b must be contiguous")
    if any(t.data_ptr() % 16 for t in (x, w, a, b)):
        raise ValueError("x, w, a and b must start at 16-byte aligned "
                         "addresses")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k_dim)
    m = x2.shape[0]
    if m == 0:
        return torch.empty((*lead, n), dtype=x.dtype, device=x.device)
    p = plan(m, k_dim, n, r, x.dtype, block_n=block_n)
    out = run_plan(p, x2, w, a, b, scaling).reshape(*lead, n)
    lora_matmul_fused.launches += 1
    lora_matmul_fused.variants[p.variant] += 1
    lora_matmul_fused.padded += int(p.padded)
    return out


@functools.lru_cache(maxsize=256)
def plan_bwd(m: int, k: int, n: int, r: int, dtype: torch.dtype) -> Plan:
    """The plan of the input gradient of a call with x (m, k), w (k, n),
    a (k, r), b (r, n): bf16 only (``wgmma``; raises on any other dtype).
    ``r_pad``: g_xa's width, r rounded up to 64 (its split is 3 r_pad
    wide); ``k_pad``: dx's width, tiled 128 wide (``block_n``: the tile
    that holds both of the kernel's f32 accumulators in registers);
    ``n_pad``: the depth, to which g, W and B are zero-padded; ``r_a``:
    A's padded width. ``grid``: the main kernel's blocks,
    ``prepass_grid``: the pre-pass's."""
    if min(m, k, n, r) < 1:
        raise ValueError(f"empty lora_matmul M={m} K={k} N={n} r={r}")
    if dtype != torch.bfloat16:
        raise ValueError(f"the lora_matmul input-gradient kernel takes "
                         f"bf16, got {dtype}")
    r_pad = round_up(r, 64)
    k_pad, n_pad, r_a = round_up(k, 8), round_up(n, 8), round_up(r, 8)
    return Plan("wgmma", r_pad, k_pad, n_pad, r_a, 128,
                (_cdiv(m, 128) * _cdiv(k_pad, 128), 1),
                (_cdiv(m, 32), r_pad // 64),
                padded=(k_pad, n_pad, r_a) != (k, n, r))


def pad_bwd_operands(p: Plan, g: torch.Tensor, w: torch.Tensor,
                     a: torch.Tensor, b: torch.Tensor):
    """(M, N) ``g``, w, b zero-padded along N to ``p.n_pad`` and a along
    r to ``p.r_a`` (unchanged where the plan says nothing). K is never
    padded: the kernel reads W's and A's rows past K as zeros."""
    n = w.shape[1]
    if p.n_pad != n:
        g, w, b = (F.pad(t, (0, p.n_pad - n)) for t in (g, w, b))
    if p.r_a != a.shape[1]:
        a = F.pad(a, (0, p.r_a - a.shape[1]))
    return g, w, a, b


def prepass_bwd(p: Plan, g: torch.Tensor, b: torch.Tensor,
                scaling: float):
    """The input gradient's pre-pass alone (counted nowhere): g_xa (M,
    r_pad) f32 = scaling * g @ b.T, columns past r zero, and its split (M,
    3 r_pad) bf16 ``[hi | mid | lo]``, hi + mid + lo == g_xa exactly.
    ``g`` (M, p.n_pad) and ``b`` (r, p.n_pad) as ``pad_bwd_operands``
    gives them, on the current device."""
    m, r = g.shape[0], b.shape[0]
    gxa = torch.empty((m, p.r_pad), dtype=torch.float32, device=g.device)
    split = torch.empty((m, 3 * p.r_pad), dtype=g.dtype, device=g.device)
    err = _lib().lora_gxa_launch(
        g.data_ptr(), b.data_ptr(), gxa.data_ptr(), split.data_ptr(), m,
        p.n_pad, r, p.r_pad, float(scaling), *p.prepass_grid, _stream(g))
    _raise_on(err, "input-gradient pre-pass", p, g, r)
    return gxa, split


def lora_matmul_bwd(g: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                    b: torch.Tensor, *, scaling: float = 1.0,
                    dx: bool = True):
    """The input gradient of ``lora_matmul`` on the card: g (M, N), the
    output's gradient; w (K, N), a (K, r), b (r, N); all bf16 on one CUDA
    device. Returns (dx (M, K) bf16 = g @ w.T + g_xa @ a.T, summed in f32
    and rounded once, or None with ``dx=False``; g_xa (M, r) f32 =
    scaling * g @ b.T, which dA takes). w, a and b must be contiguous and
    16-byte aligned, as the forward's kernel took them; g is made so."""
    if not (g.dtype == w.dtype == a.dtype == b.dtype == torch.bfloat16):
        raise ValueError(f"dtypes g={g.dtype} w={w.dtype} a={a.dtype} "
                         f"b={b.dtype}: the input-gradient kernel takes "
                         f"bf16 for all four")
    if g.dim() != 2 or w.dim() != 2 or a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"shapes g={tuple(g.shape)} w={tuple(w.shape)} "
                         f"a={tuple(a.shape)} b={tuple(b.shape)}: need "
                         f"g (M, N), w (K, N), a (K, r), b (r, N)")
    (k, n), r = w.shape, a.shape[1]
    if g.shape[1] != n or a.shape[0] != k or b.shape != (r, n) or r < 1:
        raise ValueError(f"shapes g={tuple(g.shape)} w={tuple(w.shape)} "
                         f"a={tuple(a.shape)} b={tuple(b.shape)} disagree")
    if g.device.type != "cuda":
        raise ValueError(f"the Hopper lora_matmul kernel takes CUDA tensors, "
                         f"got {g.device}")
    if not (g.device == w.device == a.device == b.device):
        raise ValueError("g, w, a and b must share one device")
    if not all(t.is_contiguous() for t in (w, a, b)) \
            or any(t.data_ptr() % 16 for t in (w, a, b)):
        raise ValueError("w, a and b must be contiguous and start at "
                         "16-byte aligned addresses")
    g = g.contiguous()
    if g.data_ptr() % 16:
        g = g.clone()
    m = g.shape[0]
    if m == 0:
        return (torch.empty((0, k), dtype=g.dtype, device=g.device)
                if dx else None,
                torch.empty((0, r), dtype=torch.float32, device=g.device))
    p = plan_bwd(m, k, n, r, g.dtype)
    g, w, a, b = pad_bwd_operands(p, g, w, a, b)
    out = None
    with torch.cuda.device(g.device):
        gxa, split = prepass_bwd(p, g, b, scaling)
        if dx:
            out = torch.empty((m, p.k_pad), dtype=g.dtype, device=g.device)
            err = _lib().lora_dx_launch(
                split.data_ptr(), g.data_ptr(), w.data_ptr(), a.data_ptr(),
                out.data_ptr(), m, p.k_pad, p.n_pad, k, p.r_a, p.r_pad,
                p.grid[0], _stream(g))
            _raise_on(err, "input-gradient main", p, g, r)
            if p.k_pad != k:
                out = out[:, :k]
    lora_matmul_bwd.launches += 1
    lora_matmul_bwd.variants[p.variant] += 1
    lora_matmul_bwd.padded += int(p.padded)
    return out, gxa[:, :r]


def reset_counts() -> None:
    """Zero the counts: ``launches`` (wrapper calls that launched the
    pre-pass and the main pass), ``variants`` (those calls by variant,
    ``wgmma`` or ``fma_f32``) and ``padded`` (those that zero-padded a
    ragged K, N or r), of ``lora_matmul_fused`` and of
    ``lora_matmul_bwd`` (whose ``launches`` are calls that launched the
    pre-pass, and the main pass where dx was asked for); and
    ``lora_matmul_bwd.plain``, the backward calls on the card that ran
    the plain f32 products."""
    for fn in (lora_matmul_fused, lora_matmul_bwd):
        fn.launches = 0
        fn.variants = collections.Counter()
        fn.padded = 0
    lora_matmul_bwd.plain = 0


reset_counts()
