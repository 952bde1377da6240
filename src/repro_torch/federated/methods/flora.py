"""FLoRA (Wang et al. 2024) proxy — heterogeneous client LoRA ranks (the
JAX package's ``repro.federated.methods.flora``).

Clients hold different ranks; updates are masked beyond each client's
rank and rank-weighted averaged (the stacking-free approximation noted
in DESIGN.md §7). Rank assignment comes from ``FedConfig.flora_ranks``
or the default r/(1+c%4) spread, injected by
``aggregation.extra_kwargs``. On heterogeneous fleets the per-client
``weights`` vector scales the rank mask, so a dropped straggler
vanishes from every rank column it would have reached (DESIGN.md §3).
"""
from __future__ import annotations

from repro_torch.federated.methods.base import AggregateContract, Strategy
from repro_torch.federated.methods.registry import register


@register()
class FLoRA(Strategy):
    name = "flora"
    description = "heterogeneous-rank LoRA averaging (Wang et al. 2024)"
    aggregation = "flora"
    composable = True
    contract = AggregateContract(
        uplink="rank_mask",
        notes="updates masked beyond each client's rank; full-tree bytes")
