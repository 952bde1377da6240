"""Canonical shape families for the kernel contracts (the JAX package's
``contracts/shapes.py``: the same five families, tags, shapes and
dtypes).

Each family yields ``(tag, args, kwargs)`` cases where ``args`` is an
ordered ``{name: tensor}`` mapping in the kernel's positional order and
``kwargs`` holds the keyword arguments (tensors among them, such as
``kv_valid_len``). The tensors lie on the given device: ``meta`` (the
default) gives shapes and dtypes with no storage; any other device gets
values from a generator seeded with ``seed`` (normal operands; ``dt``
and ``-a`` of the SSD positive, as the model feeds them; valid lengths
in ``[1, capacity]``).

The dims are the JAX package's: its benchmark suite's SMALL budget
(local_batch=4, seq=32, lora_rank=8) over the reduced bench-small model
(d_model=128, 4 heads, head_dim=32), plus the bench's 4x variants;
``tests/test_torch_contracts.py`` pins them against JAX's ``FAMILIES``.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import torch

Case = Tuple[str, Dict[str, Any], Dict[str, Any]]

F32, I32 = torch.float32, torch.int32
_B, _S, _R = 4, 32, 8            # SMALL budget: local_batch, seq, lora_rank
_D, _H, _HD = 128, 4, 32         # bench-small reduced llama2-7b-proxy


class _Draw:
    """Tensors of given shapes on ``device``: empty on ``meta``, else
    drawn from one generator seeded with ``seed``."""

    def __init__(self, device, seed: int):
        self.device = torch.device(device)
        self.gen = None if self.device.type == "meta" else \
            torch.Generator(device=self.device).manual_seed(seed)

    def _empty(self, shape, dtype):
        return torch.empty(shape, dtype=dtype, device=self.device)

    def normal(self, *shape):
        if self.gen is None:
            return self._empty(shape, F32)
        return torch.randn(shape, generator=self.gen, dtype=F32,
                           device=self.device)

    def uniform(self, lo: float, hi: float, *shape):
        if self.gen is None:
            return self._empty(shape, F32)
        u = torch.rand(shape, generator=self.gen, dtype=F32,
                       device=self.device)
        return lo + (hi - lo) * u

    def ints(self, lo: int, hi: int, *shape):
        """int32 in ``[lo, hi]``."""
        if self.gen is None:
            return self._empty(shape, I32)
        return torch.randint(lo, hi + 1, shape, generator=self.gen,
                             dtype=I32, device=self.device)


def _attention(t: _Draw) -> Iterator[Case]:
    # MHA (reduced llama2-7b-proxy: kv == heads), the bench's 4x-seq
    # variant, and the GQA shape (reduced qwen2-7b: 2 kv heads)
    for tag, s, hkv in ((f"b{_B}_s{_S}_h{_H}kv{_H}_d{_HD}", _S, _H),
                        (f"b{_B}_s{4 * _S}_h{_H}kv{_H}_d{_HD}", 4 * _S, _H),
                        (f"b{_B}_s{_S}_h{_H}kv2_d{_HD}", _S, 2)):
        yield tag, {"q": t.normal(_B, s, _H, _HD),
                    "k": t.normal(_B, s, hkv, _HD),
                    "v": t.normal(_B, s, hkv, _HD)}, {"causal": True}


def _lora(t: _Draw) -> Iterator[Case]:
    m, k, n = _B * _S, _D, _H * _HD
    for m_ in (m, 4 * m):
        yield f"m{m_}_k{k}_n{n}_r{_R}", \
            {"x": t.normal(m_, k), "w": t.normal(k, n),
             "a": t.normal(k, _R), "b": t.normal(_R, n)}, \
            {"scaling": 2.0}


def _ssd(t: _Draw) -> Iterator[Case]:
    # reduced mamba2-2.7b: d_inner = expand*d_model = 256, head_dim=32
    # -> 8 SSD heads, d_state=16, 1 B/C group, chunk=32
    h, p, n, g, chunk = 8, 32, 16, 1, 32
    yield f"b{_B}_s{_S}_h{h}_p{p}_n{n}", \
        {"x": t.normal(_B, _S, h, p), "dt": t.uniform(0.01, 0.1, _B, _S, h),
         "a": -t.uniform(0.5, 2.0, h), "b": t.normal(_B, _S, g, n),
         "c": t.normal(_B, _S, g, n), "d": t.normal(h)}, \
        {"chunk": chunk}


def _moe_ffn(t: _Draw) -> Iterator[Case]:
    # (E, C, d) expert buffers at bench-small width, 4 experts,
    # capacity 16, expert FFN width 64
    e, c, ff = 4, 16, 64
    yield f"e{e}_c{c}_d{_D}_ff{ff}", \
        {"buf": t.normal(e, c, _D), "wg": t.normal(e, _D, ff),
         "wu": t.normal(e, _D, ff), "wd": t.normal(e, ff, _D)}, {}


def _decode(t: _Draw) -> Iterator[Case]:
    # single-token decode over a ragged GQA cache (the engine's hot
    # step): 4 slots, capacity 64, reduced qwen2-7b kv heads
    cap, hkv = 64, 2
    yield f"b{_B}_cap{cap}_h{_H}kv{hkv}_d{_HD}", \
        {"q": t.normal(_B, 1, _H, _HD),
         "k": t.normal(_B, cap, hkv, _HD),
         "v": t.normal(_B, cap, hkv, _HD)}, \
        {"kv_valid_len": t.ints(1, cap, _B)}
    # absorbed-MLA decode: a single shared latent head (hkv=1), qk over
    # rank+rope (32+16), v over the latent rank alone — the case where
    # the output head dim differs from qk's ("q^v" contract)
    qk, vd = 48, 32
    yield f"b{_B}_cap{cap}_h{_H}kv1_qk{qk}_v{vd}", \
        {"q": t.normal(_B, 1, _H, qk),
         "k": t.normal(_B, cap, 1, qk),
         "v": t.normal(_B, cap, 1, vd)}, \
        {"kv_valid_len": t.ints(1, cap, _B)}


FAMILIES = {
    "attention": _attention,
    "lora": _lora,
    "ssd": _ssd,
    "moe_ffn": _moe_ffn,
    "decode": _decode,
}


def kernel_cases(family: str, device="meta", seed: int = 0
                 ) -> Iterator[Case]:
    try:
        gen = FAMILIES[family]
    except KeyError:
        raise KeyError(f"unknown shape family {family!r}; "
                       f"known: {sorted(FAMILIES)}") from None
    return gen(_Draw(device, seed))
