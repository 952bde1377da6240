"""FedIT (Zhang et al. 2024) — the plain-FedAvg LoRA baseline.

Full model every round, client LoRA deltas averaged server-side. This is
the reference point for every cost comparison in the paper (Fig. 5-7).
"""
from __future__ import annotations

from repro_torch.federated.methods.base import AggregateContract, Strategy
from repro_torch.federated.methods.registry import register


@register()
class FedIT(Strategy):
    name = "fedit"
    description = "full-model LoRA + FedAvg (Zhang et al. 2024)"
    aggregation = "fedavg"
    composable = True
    contract = AggregateContract(uplink="full")
