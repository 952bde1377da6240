"""C2A (Kim et al. 2023) proxy — hypernetwork-generated adapters (the JAX
package's ``repro.federated.methods.c2a``).

In C2A adapters are *generated* per round from client context rather
than persisted; we proxy that by resetting the B matrices to zero after
aggregating A, so every round re-derives its adapter from the shared A
basis (DESIGN.md §7).
"""
from __future__ import annotations

import torch

from repro_torch.federated.methods.base import AggregateContract, Strategy
from repro_torch.federated.methods.registry import register
from repro_torch.lora import is_lora_b


def _zero_b(tree, path=()):
    """``tree`` with every B leaf replaced by fresh zeros. New tensors,
    never ``zero_()``: an aggregated leaf may alias a client's update."""
    if isinstance(tree, dict):
        return {k: _zero_b(v, path + (k,)) for k, v in tree.items()}
    return torch.zeros_like(tree) if is_lora_b(path) else tree


@register()
class C2A(Strategy):
    name = "c2a"
    description = "per-round generated adapters; B resets (Kim et al. 2023)"
    aggregation = "fedavg"
    contract = AggregateContract(
        uplink="full",
        notes="post_round zeros B server-side; aggregate itself is fedavg")

    def post_round(self, state, new_lora):
        return super().post_round(state, _zero_b(new_lora))
