"""DEVFT — developmental federated fine-tuning (the paper's method).

Stages follow the capacity schedule (§2.2); each stage trains a fused
submodel built by DGLG grouping + DBLF fusion (``repro_torch.core``), and the
trained LoRA transfers back to the global model via group broadcast
(§3.4). Client LR rises ×``lr_stage_factor`` per stage to ``fed.lr``
(paper App. B).

The ``DevFTController`` in ``repro_torch.core.devft`` is this strategy's stage
engine; the strategy adapts it to the generic round loop.
"""
from __future__ import annotations

from repro_torch.analysis.tracing import span
from repro_torch.core import DevFTController
from repro_torch.federated.methods.base import AggregateContract, StagedStrategy
from repro_torch.federated.methods.registry import register


@register()
class DevFT(StagedStrategy):
    name = "devft"
    description = "developmental stages: DGLG grouping + DBLF fusion (paper)"
    aggregation = "fedavg"
    contract = AggregateContract(
        uplink="full",
        notes="per-stage submodel trees; avals preserved within a stage")

    def init_state(self, params, lora):
        state = super().init_state(params, lora)
        fed = self.fed
        state["ctl"] = DevFTController(self.cfg, state["sched"],
                                       beta=fed.beta,
                                       grouping=fed.grouping,
                                       fusion=fed.fusion, seed=fed.seed)
        return state

    def on_stage(self, state, stage):
        ctl = state["ctl"]
        with span("devft.stage_entry"):
            if state["sub"] is not None:
                state["lora"] = ctl.finish_stage(state["lora"],
                                                 state["sub"].lora)
            state["sub"] = ctl.start_stage(state["params"], state["lora"],
                                           stage)

    def client_lr(self, stage):
        # paper App. B: LR rises x`lr_stage_factor` per stage to fed.lr
        # (1e-6 -> 1e-4 with the paper's factor 10), expressed relative
        # to fed.lr so it scales to any run size
        fed = self.fed
        f = fed.lr_stage_factor
        lr = fed.lr * min(f ** (stage - (fed.n_stages - 1)), 1.0)
        return max(lr, fed.lr * f ** -(fed.n_stages - 1))

    def finalize(self, state):
        if state["sub"] is not None:
            state["lora"] = state["ctl"].finish_stage(state["lora"],
                                                      state["sub"].lora)
            state["sub"] = None
        return state["lora"]
