"""ProgFed (Wang et al. 2022) — progressive *prefix* growth baseline (the
JAX package's ``repro.federated.methods.progfed``).

Trains the first-``capacity`` layers of each stack per stage
(proportionally allocated across heterogeneous stacks), growing on the
DEVFT schedule but with no grouping/fusion and no knowledge transfer
beyond copying the trained prefix back.

Protocol note (kept for seed parity, pinned by the reference's golden
round logs): each stage's prefix submodel is rebuilt from the *initial*
global LoRA, and only the final stage's training is transferred back at
``finalize`` — intermediate stages act as warm-up for the logged
trajectory, not as carried-forward state. A carry-forward variant
(transfer at every ``on_stage``) would be a one-line change here but a
numerical-behavior change everywhere it is benchmarked.

The prefix slices are views of the global trees. Nothing writes through
them: local training and aggregation return new tensors, and
``prefix_transfer`` clones before it assigns.
"""
from __future__ import annotations

from repro_torch.core.devft import Submodel, _sub_cfg
from repro_torch.core.stages import allocate_stack_capacities
from repro_torch.federated.methods.base import AggregateContract, StagedStrategy
from repro_torch.federated.methods.registry import register
from repro_torch.interop import tree_map
from repro_torch.models.transformer import stack_sizes


def prefix_submodel(cfg, params, lora, capacity: int) -> Submodel:
    """First-``capacity`` layers of each stack (proportional), no fusion."""
    sizes = stack_sizes(params["blocks"])
    caps = allocate_stack_capacities(sizes, capacity)
    blocks, lo, plan = {}, {}, {}
    for name, stack in params["blocks"].items():
        c = caps.get(name, sizes[name])
        blocks[name] = tree_map(lambda a, c=c: a[:c], stack)
        if name in lora:
            lo[name] = tree_map(lambda a, c=c: a[:c], lora[name])
        plan[name] = {"groups": [[i] for i in range(c)],
                      "n_layers": sizes[name], "prefix": c}
    sub_params = dict(params)
    sub_params["blocks"] = blocks
    return Submodel(cfg=_sub_cfg(cfg, caps), params=sub_params, lora=lo,
                    plan=plan, capacity=capacity)


def _put(g, s):
    """``g.at[:len(s)].set(s)``: a new tensor, ``g`` untouched."""
    out = g.clone()
    out[: s.shape[0]] = s
    return out


def prefix_transfer(global_lora: dict, sub_lora: dict) -> dict:
    new = dict(global_lora)
    for name, lo in sub_lora.items():
        new[name] = tree_map(_put, global_lora[name], lo)
    return new


@register()
class ProgFed(StagedStrategy):
    name = "progfed"
    description = "progressive prefix growth (Wang et al. 2022)"
    aggregation = "fedavg"
    contract = AggregateContract(
        uplink="full",
        notes="prefix submodel trees; avals preserved within a stage")

    def on_stage(self, state, stage):
        cap = state["sched"].capacities[stage]
        state["sub"] = prefix_submodel(self.cfg, state["params"],
                                       state["lora"], cap)

    def finalize(self, state):
        if state["sub"] is not None:
            state["lora"] = prefix_transfer(state["lora"],
                                            state["sub"].lora)
            state["sub"] = None
        return state["lora"]
