"""Constants shared by the Hopper kernels, their plain PyTorch versions
and the model layers.

``NEG_INF`` is the additive masking value of every attention path. It
is a large *finite* float32, not ``-inf``: ``exp(NEG_INF - NEG_INF)``
stays 1, so a fully masked softmax row is NaN-free, and the value
survives a bf16 round trip. It must equal the JAX package's constant so
the two packages mask logits identically; ``csrc/flash_decode.cu``
spells the same value.
"""
from __future__ import annotations

NEG_INF = -1e30


def round_up(x: int, mult: int) -> int:
    return -(-x // mult) * mult
