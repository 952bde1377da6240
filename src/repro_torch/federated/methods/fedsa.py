"""FedSA-LoRA (Guo et al. 2024) — share only the LoRA A matrices (the
JAX package's ``repro.federated.methods.fedsa``).

B stays client-local; uplink cost roughly halves. All of the behaviour
lives in the ``fedsa`` aggregator (``repro_torch.federated.aggregation``);
the strategy just selects it, which is exactly why it composes with DEVFT
(paper Table 4) and with heterogeneous fleets (the per-client
``weights`` vector flows through ``Strategy.aggregate`` into the
aggregator's weighted combine — DESIGN.md §3).

Accounting note (kept for seed parity, pinned by the reference's golden
round logs): downlink uses the default full-tree hook even though only A
is broadcast in FedSA-LoRA proper, so logged downlink is an upper bound —
overriding ``downlink_bytes`` to count A only is the one-line tighter
variant, but a numerical-behavior change in every comm table.
"""
from __future__ import annotations

from repro_torch.federated.aggregation import _a_bytes
from repro_torch.federated.methods.base import AggregateContract, Strategy
from repro_torch.federated.methods.registry import register


@register()
class FedSA(Strategy):
    name = "fedsa"
    description = "A-only sharing, B client-local (Guo et al. 2024)"
    aggregation = "fedsa"
    composable = True
    contract = AggregateContract(
        uplink="a_only",
        notes="B stays client-local; uplink counts A matrices only")

    def uplink_payload_bytes(self, spec):
        # the virtual clock must charge the A-only payload the ``fedsa``
        # aggregator reports, not the full tree — otherwise sim_time and
        # comm_bytes_up disagree within one RoundLog row
        return _a_bytes(spec.lora)
