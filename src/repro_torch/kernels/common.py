"""Constants shared by the Hopper kernels, their plain PyTorch versions,
the model layers and the roofline bounds.

``NEG_INF`` is the additive masking value of every attention path. It
is a large *finite* float32, not ``-inf``: ``exp(NEG_INF - NEG_INF)``
stays 1, so a fully masked softmax row is NaN-free, and the value
survives a bf16 round trip. It must equal the JAX package's constant so
the two packages mask logits identically; ``csrc/flash_decode.cu``
spells the same value.
"""
from __future__ import annotations

NEG_INF = -1e30

# Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet; dense
# rates, no sparsity, at the full 700 W power limit). Datasheet numbers,
# not measurements: the bounds and the dry-run's roofline use them.
#: HBM3 bandwidth, bytes/s
H100_HBM_BYTES_PER_S = 3.35e12
#: HBM3 capacity, bytes ("80 GB")
H100_HBM_BYTES = 80e9
#: dense bf16 (and fp16) tensor-core rate, FLOP/s
H100_BF16_FLOPS = 989e12
#: float32 outside the tensor cores, FLOP/s
H100_F32_FLOPS = 67e12


def round_up(x: int, mult: int) -> int:
    return -(-x // mult) * mult
