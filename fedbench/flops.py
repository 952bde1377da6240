"""The floating-point operations a local step and an eval forward need,
counted from the shapes: frozen weights get no weight gradient (their
backward is the input gradient alone, as many operations as their
forward), LoRA factors get both, only the top-k experts run, causal
attention counts half the score matrix, the SSD scan its chunked work,
and nothing is recomputed.
"""
from __future__ import annotations

from typing import Dict

from fedbench.reference.model import padded_vocab, stack_kinds


def _attention(m: dict, s: int, r: int):
    d, h, hkv = m["d_model"], m["n_heads"], m["n_kv_heads"]
    hd = m.get("head_dim") or d // h
    frozen = 2 * d * (h * hd + 2 * hkv * hd) + 2 * h * hd * d
    lora = 2 * r * (d + h * hd) + 2 * r * (d + hkv * hd)
    scores = 2 * h * hd * s          # QK^T and PV over the causal half
    return frozen, lora, scores


def _mamba(m: dict, s: int, r: int):
    mb, d = m["mamba"], m["d_model"]
    din = mb["expand"] * d
    h = din // mb["head_dim"]
    gn = mb["n_groups"] * mb["d_state"]
    n_in = 2 * din + 2 * gn + h
    frozen = 2 * d * n_in + 2 * din * d + 2 * mb["conv_width"] * (din + 2 * gn)
    lora = 2 * r * (d + n_in) + 2 * r * (din + d)
    q = min(mb["chunk"], s)
    scan = h * (q * (mb["d_state"] + mb["head_dim"])
                + 4 * mb["head_dim"] * mb["d_state"])
    return frozen, lora, scan


def _ffn(m: dict, kind: str):
    d = m["d_model"]
    if kind.endswith("moe"):
        mo = m["moe"]
        return 2 * d * mo["n_experts"] + mo["top_k"] * 6 * d * mo["d_ff_expert"]
    return 6 * d * m["d_ff"]


def per_token(m: dict, sizes: Dict[str, int], s: int, r: int):
    """(forward, backward) operations a token of a sequence of ``s``
    takes through a (sub)model of ``sizes`` layers per stack."""
    fwd = bwd = 0.0
    for name, kind in stack_kinds(m).items():
        n = sizes.get(name, 0)
        if kind.startswith("mamba"):
            frozen, lora, seq = _mamba(m, s, r)
        else:
            frozen, lora, seq = _attention(m, s, r)
        if kind != "mamba_only":
            frozen += _ffn(m, kind)
        fwd += n * (frozen + lora + seq)
        bwd += n * (frozen + 2 * lora + 2 * seq)
    head = 2 * m["d_model"] * padded_vocab(m)
    return fwd + head, bwd + head


def round_flops(m: dict, sizes: Dict[str, int], spec: dict, n_sample: int,
                eval_rows: int, r: int) -> float:
    """One round: every sampled client's K steps and the eval forward."""
    s = spec["seq"]
    fwd, bwd = per_token(m, sizes, s, r)
    train = n_sample * spec["k_local"] * spec["local_batch"] * s * (fwd + bwd)
    return train + eval_rows * s * fwd
