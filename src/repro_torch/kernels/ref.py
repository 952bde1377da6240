"""Plain PyTorch versions of the Hopper kernels (model layout).

Each is registered as the kernel's ``reference`` backend in
``repro_torch.kernels.dispatch``, runs whenever the inputs lie on the
CPU, and is what the chip smoke run holds each kernel against on the
card.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels.common import NEG_INF


def flash_decode_ref(q, k, v, *, kv_valid_len, scale=None):
    """Single-token ragged-cache decode attention. q: (B, 1, H, hd);
    k: (B, C, Hkv, hd); v: (B, C, Hkv, vd) cache-resident;
    ``kv_valid_len (B,)`` masks each slot's dead cache entries.

    Exactly ``layers.attend(causal=False, kv_valid_len=...)``: f32
    scores, the ``NEG_INF`` logit mask, zeros for a slot with
    ``valid == 0``, probabilities cast to ``v.dtype`` before the PV
    product — so the result is (B, 1, H, vd) in ``v.dtype``."""
    # lazy: kernels -> models only at call time (no import cycle)
    from repro_torch.models.layers import attend

    return attend(q, k, v, causal=False, kv_valid_len=kv_valid_len,
                  scale=scale)


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None,
                        scale: Optional[float] = None):
    """q, k, v: (B, H, S, D) -> (B, H, S, D); plain softmax attention in
    f32 (scores, the ``NEG_INF`` mask, probabilities and the PV product),
    output in ``q.dtype``."""
    s, d = q.shape[2], q.shape[3]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    sc = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    sc = torch.where(mask, sc, NEG_INF)
    p = torch.softmax(sc, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def attention_bshd_ref(q, k, v, *, causal: bool = True,
                       window: Optional[int] = None,
                       scale: Optional[float] = None):
    """Model layout: q (B, S, H, D); k, v (B, S, Hkv, D) -> (B, S, H, D).
    The plain version of the ``flash_attention`` kernel and the function
    its backward differentiates; GQA repeats each kv head H / Hkv times."""
    h, hkv = q.shape[2], k.shape[2]
    if hkv != h:
        k = torch.repeat_interleave(k, h // hkv, dim=2)
        v = torch.repeat_interleave(v, h // hkv, dim=2)
    out = flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=causal,
                              window=window, scale=scale)
    return out.transpose(1, 2)


def lora_matmul_ref(x, w, a, b, *, scaling: float = 1.0):
    """x: (..., K); w (K, N); a (K, r); b (r, N). All products in f32
    with no intermediate rounding; output in ``x.dtype``. ``scaling`` is
    alpha / r. The plain version of the ``lora_matmul`` kernel and the
    function its backward differentiates."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).float()
    y = x2 @ w.float()
    lo = (x2 @ a.float()) @ b.float()
    out = (y + scaling * lo).to(x.dtype)
    return out.reshape(*lead, w.shape[1])


def moe_expert_ffn_ref(buf, wg, wu, wd, *, fill=None):
    """Batched SwiGLU over per-expert capacity buffers (the JAX package's
    ``expert_ffn_reference``): buf (E, C, d); wg, wu (E, d, ff); wd
    (E, ff, d) -> (E, C, d). Each einsum runs in the input dtype, as in
    JAX, so in bf16 gate, up, the SwiGLU and the output each round. The
    plain version of the ``moe_expert_ffn`` kernel and the function its
    backward differentiates; the kernel's own arithmetic (f32 inside, one
    rounding) is this function on f32 copies, rounded once.

    ``fill``: None, or (E,) integers; expert e's rows at or past
    ``fill[e]`` give exact zeros (the kernel skips them). Where those
    rows of buf are zero, as ``moe_block`` leaves them, the result is the
    same bits with and without it."""
    h = torch.nn.functional.silu(torch.einsum("ecd,edf->ecf", buf, wg)) \
        * torch.einsum("ecd,edf->ecf", buf, wu)
    out = torch.einsum("ecf,efd->ecd", h, wd)
    if fill is None:
        return out
    rows = torch.arange(buf.shape[1], device=buf.device)
    live = rows[None, :] < fill.to(buf.device)[:, None]
    return torch.where(live[..., None], out, 0)


def ssd_scan_ref(x, dt, a, b, c, d):
    """Sequential (non-chunked) SSD recurrence, the ground truth.

    x: (B, H, S, P); dt: (B, H, S) f32; a, d: (H,) f32; b, c: (B, H, S, N).
    h_t = exp(dt_t·a)·h_{t-1} + dt_t·x_t·b_tᵀ ;  y_t = h_t·c_t + d·x_t,
    the state in f32; returns (B, H, S, P) in ``x.dtype``."""
    bsz, h, s, p = x.shape
    n = b.shape[-1]
    state = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        xt, dtt = x[:, :, t].float(), dt[:, :, t]
        bt, ct = b[:, :, t].float(), c[:, :, t].float()
        decay = torch.exp(dtt * a[None, :])                 # (B, H)
        state = state * decay[..., None, None] + torch.einsum(
            "bhp,bhn,bh->bhpn", xt, bt, dtt)
        ys.append(torch.einsum("bhpn,bhn->bhp", state, ct))
    y = torch.stack(ys, dim=2)
    y = y + x.float() * d[None, :, None, None]
    return y.to(x.dtype)


def ssd_scan_bshp_ref(x, dt, a, b, c, d):
    """Model layout: x (B, S, H, P); dt (B, S, H); b, c (B, S, G, N);
    a, d (H,). The sequential oracle; b and c are repeated to H heads."""
    rep = x.shape[2] // b.shape[2]
    bt = torch.repeat_interleave(b.transpose(1, 2), rep, dim=1)
    ct = torch.repeat_interleave(c.transpose(1, 2), rep, dim=1)
    y = ssd_scan_ref(x.transpose(1, 2), dt.transpose(1, 2), a, bt, ct, d)
    return y.transpose(1, 2)


def ssd_scan_bshp_chunked_ref(x, dt, a, b, c, d, *, chunk: int = 128):
    """Model layout like ``ssd_scan_bshp_ref``, through the chunked SSD
    formulation (``repro_torch.models.mamba2.ssd_chunked``) at chunk
    ``min(chunk, S)``, the sequence zero-padded to a whole chunk. The
    plain version of the ``ssd_scan`` kernel and the function its
    backward differentiates (the O(S) sequential scan would make the
    backward far slower)."""
    # lazy: kernels -> models only at call time (no import cycle)
    from repro_torch.models.mamba2 import ssd_chunked

    s = x.shape[1]
    ck = min(chunk, s)
    pad = (-s) % ck
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        b = torch.nn.functional.pad(b, (0, 0, 0, 0, 0, pad))
        c = torch.nn.functional.pad(c, (0, 0, 0, 0, 0, pad))
    return ssd_chunked(x, dt, a, b, c, d, ck)[:, :s]
