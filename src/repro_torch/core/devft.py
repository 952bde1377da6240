"""DEVFT orchestrator — builds stage submodels and runs the developmental
schedule (paper Figure 3: ① construct submodel → ② federated fine-tune →
③ transfer knowledge, repeat for S stages); the JAX package's
``repro.core.devft``.

A *submodel* is a full model tree whose layer stacks have been fused
down to the stage capacity via DGLG grouping + DBLF fusion. The
transformer runs submodels unchanged because it reads stack depths off
the params (``stack_sizes``), not the config.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

from repro_torch.analysis.tracing import span
from repro_torch.core.fusion import fuse_stack
from repro_torch.core.grouping import make_groups
from repro_torch.core.stages import StageSchedule, allocate_stack_capacities
from repro_torch.core.transfer import transfer_stage
from repro_torch.data.synthetic import seed_entropy
from repro_torch.models.transformer import stack_sizes


@dataclasses.dataclass
class Submodel:
    cfg: Any
    params: dict
    lora: dict
    plan: Dict[str, dict]          # stack -> {'groups': [...], 'n_layers': L}
    capacity: int


# stacks that never shrink (frozen feature producers — DESIGN.md §4)
_PROTECTED = ("enc",)


def _sub_cfg(cfg, caps: Dict[str, int]):
    """Config consistent with the shrunken stacks (records/rope etc.)."""
    total = sum(caps.values())
    kw: Dict[str, Any] = {}
    if cfg.is_encdec:
        kw["n_layers"] = caps.get("dec", cfg.n_layers)
    elif cfg.moe is not None and cfg.moe.first_dense_layers:
        kw["n_layers"] = total
        kw["moe"] = dataclasses.replace(
            cfg.moe, first_dense_layers=caps.get("dense",
                                                 cfg.moe.first_dense_layers))
    else:
        kw["n_layers"] = total
    return dataclasses.replace(cfg, **kw)


def build_submodel(cfg, params: dict, lora: dict, capacity: int, *,
                   beta: float = 0.1, grouping: str = "dglg",
                   fusion: str = "dblf", seed=0) -> Submodel:
    """Construct the stage submodel (paper steps ① — §3.2 + §3.3).

    ``capacity`` counts layers across all shrinkable stacks; protected
    stacks (whisper encoder) are carried over whole. ``seed`` is an int
    or a tuple of keyed entropy (e.g. ``(base_seed, stage)``).
    """
    sizes = stack_sizes(params["blocks"])
    shrinkable = {n: s for n, s in sizes.items() if n not in _PROTECTED}
    caps = allocate_stack_capacities(shrinkable, capacity)

    new_blocks, new_lora, plan = {}, {}, {}
    for name, stack in params["blocks"].items():
        if name in _PROTECTED or caps.get(name, 0) >= sizes[name]:
            new_blocks[name] = stack
            if name in lora:
                new_lora[name] = lora[name]
            # identity plan so transfer still works for un-shrunk stacks
            if name not in _PROTECTED:
                plan[name] = {"groups": [[i] for i in range(sizes[name])],
                              "n_layers": sizes[name]}
            continue
        lo = lora.get(name)
        with span("devft.grouping"):
            groups = make_groups(grouping, stack, lo, caps[name], seed=seed)
        with span("devft.fusion"):
            new_blocks[name] = fuse_stack(stack, groups, beta, fusion,
                                          seed=seed)
            if lo is not None:
                new_lora[name] = fuse_stack(lo, groups, beta, fusion,
                                            seed=seed)
        plan[name] = {"groups": groups, "n_layers": sizes[name]}

    sub_params = dict(params)
    sub_params["blocks"] = new_blocks
    return Submodel(cfg=_sub_cfg(cfg, caps), params=sub_params,
                    lora=new_lora, plan=plan, capacity=capacity)


class DevFTController:
    """Stage state machine used by the federated round engine.

    >>> ctl = DevFTController(cfg, schedule, beta=0.1)
    >>> for stage in range(ctl.n_stages):
    ...     sub = ctl.start_stage(params, lora, stage)
    ...     trained_lora = federated_rounds(sub, ...)   # §3 step ②
    ...     lora = ctl.finish_stage(lora, trained_lora) # §3 step ③
    """

    def __init__(self, cfg, schedule: StageSchedule, *, beta: float = 0.1,
                 grouping: str = "dglg", fusion: str = "dblf", seed=0):
        self.cfg = cfg
        self.schedule = schedule
        self.beta = beta
        self.grouping = grouping
        self.fusion = fusion
        self.seed = seed
        self._current: Optional[Submodel] = None

    @property
    def n_stages(self) -> int:
        return self.schedule.n_stages

    def start_stage(self, params: dict, lora: dict, stage: int) -> Submodel:
        cap = self.schedule.capacities[stage]
        # keyed entropy, not seed arithmetic: stage streams stay disjoint
        # across base seeds (seed 0 stage 3 != seed 3 stage 0)
        sub = build_submodel(self.cfg, params, lora, cap, beta=self.beta,
                             grouping=self.grouping, fusion=self.fusion,
                             seed=(*seed_entropy(self.seed), stage))
        self._current = sub
        return sub

    def finish_stage(self, global_lora: dict, trained_sub_lora: dict) -> dict:
        assert self._current is not None, "no stage in flight"
        with span("devft.transfer"):
            new = transfer_stage(global_lora, trained_sub_lora,
                                 self._current.plan)
        self._current = None
        return new
