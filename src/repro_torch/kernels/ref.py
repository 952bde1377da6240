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


def moe_expert_ffn_ref(buf, wg, wu, wd):
    """Batched SwiGLU over per-expert capacity buffers (the JAX package's
    ``expert_ffn_reference``): buf (E, C, d); wg, wu (E, d, ff); wd
    (E, ff, d) -> (E, C, d). Each einsum runs in the input dtype, as in
    JAX, so in bf16 gate, up, the SwiGLU and the output each round. The
    plain version of the ``moe_expert_ffn`` kernel and the function its
    backward differentiates; the kernel's own arithmetic (f32 inside, one
    rounding) is this function on f32 copies, rounded once."""
    h = torch.nn.functional.silu(torch.einsum("ecd,edf->ecf", buf, wg)) \
        * torch.einsum("ecd,edf->ecf", buf, wu)
    return torch.einsum("ecf,efd->ecd", h, wd)
