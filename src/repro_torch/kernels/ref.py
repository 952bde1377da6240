"""Plain PyTorch versions of the Hopper kernels (model layout).

Each is registered as the kernel's ``reference`` backend in
``repro_torch.kernels.dispatch``, runs whenever the inputs lie on the
CPU, and is what the chip smoke run holds each kernel against on the
card.
"""
from __future__ import annotations


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
