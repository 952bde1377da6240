"""Strategy API — the hook contract every federated method implements
(the JAX package's ``repro.federated.methods.base``).

The round engine (``repro_torch.federated.simulator.FederatedRunner``) is
method-agnostic: it samples clients, runs local training, and logs cost
accounting, while everything method-specific flows through the hooks
below (DESIGN.md §2). Adding a method is a one-file drop-in:

    from repro_torch.federated.methods import Strategy, register

    @register()
    class MyMethod(Strategy):
        name = "mymethod"
        aggregation = "fedavg"

Lifecycle, per ``FederatedRunner.run()``:

    strategy = make_strategy(fed.method, cfg, fed)   # at runner init
    lora  = strategy.init_lora(params, lora)         # at runner init
    state = strategy.init_state(params, lora)        # at run() start
    for rnd, (stage, capacity) in enumerate(strategy.build_rounds(state)):
        strategy.on_stage(state, stage)              # only on stage change
        spec = strategy.local_spec(state)            # what clients train
        lr = strategy.client_lr(stage)
        client_loras = local_train(spec, ...)        # K-step AdamW per client
        # (heterogeneous runs pass per-client step masks into local_train
        #  and a per-client `weights` vector into aggregate)
        new_lora, up = strategy.aggregate(state, spec, client_loras, n)
        new_lora = strategy.post_round(state, new_lora)
        log(strategy.uplink_bytes(up, n), strategy.downlink_bytes(new_lora, n))
    global_lora = strategy.finalize(state)
"""
from __future__ import annotations

import dataclasses
from typing import Any, ClassVar, Dict, List, Tuple

from repro_torch.core import make_schedule
from repro_torch.federated import aggregation as agg_mod


@dataclasses.dataclass(frozen=True)
class AggregateContract:
    """Declared contract of a Strategy's round, kept as data (the JAX
    package verifies it with its analysis tooling, which the port does
    not have yet): the aggregated adapter tree carries the shapes and
    dtypes of the incoming global tree, and the per-client uplink byte
    count is a Python int computable from shapes.

    ``uplink`` documents what the method actually transmits:
    ``"full"`` (whole adapter tree), ``"a_only"`` (FedSA),
    ``"rank_mask"`` (FLoRA rank-masked tree)."""
    preserves_adapter_avals: bool = True
    uplink: str = "full"
    notes: str = ""


@dataclasses.dataclass
class LocalSpec:
    """What the sampled clients train this round: a (possibly fused or
    truncated) model view; ``cfg`` is consistent with ``params``."""
    cfg: Any
    params: dict
    lora: dict


def total_layers(cfg) -> int:
    return sum(s for _, s in cfg.layer_stacks())


class Strategy:
    """Base federated method: full-model LoRA fine-tuning every round
    (the FedIT protocol). Subclasses override hooks; every hook has a
    sensible default so minimal methods only set class attributes.

    State is an explicit dict (created by ``init_state``) rather than
    instance attributes so a single Strategy object stays reusable
    across repeated ``run()`` calls.
    """

    #: registry key; set by ``@register()`` if a name is passed there.
    name: ClassVar[str] = ""
    #: one-line description surfaced by CLIs / benchmark tables.
    description: ClassVar[str] = ""
    #: default server aggregator (a ``repro_torch.federated.aggregation``
    #: name);
    #: ``FedConfig.aggregation`` overrides it per run (Table 4 composes
    #: DEVFT with other methods' aggregators this way).
    aggregation: ClassVar[str] = "fedavg"
    #: True if this method is *defined by* its aggregation rule, i.e. it
    #: composes with DEVFT's developmental schedule (drives the Table-4
    #: compatibility grid).
    composable: ClassVar[bool] = False
    #: declared round contract (see ``AggregateContract``)
    contract: ClassVar[AggregateContract] = AggregateContract()

    def __init__(self, cfg, fed):
        self.cfg = cfg
        self.fed = fed

    # ---- lifecycle ------------------------------------------------------
    def init_lora(self, params: dict, lora: dict) -> dict:
        """Transform the freshly initialised global adapters (called once
        at runner construction; DoFIT's SVD init lives here)."""
        return lora

    def init_state(self, params: dict, lora: dict) -> Dict[str, Any]:
        """Build the per-run mutable state. Must keep the global adapter
        tree under ``'lora'``; put schedules/controllers beside it."""
        return {"params": params, "lora": lora}

    def build_rounds(self, state: Dict[str, Any]) -> List[Tuple[int, int]]:
        """Per-round ``(stage, capacity)`` pairs; len == total rounds."""
        return [(0, total_layers(self.cfg))] * self.fed.rounds

    def on_stage(self, state: Dict[str, Any], stage: int) -> None:
        """Stage transition (engine calls this only when the stage id
        changes). Staged methods close out the previous submodel and
        build the next one here."""

    def local_spec(self, state: Dict[str, Any]) -> LocalSpec:
        """The model view clients train this round."""
        return LocalSpec(self.cfg, state["params"], state["lora"])

    def client_lr(self, stage: int) -> float:
        return self.fed.lr

    def aggregate(self, state: Dict[str, Any], spec: LocalSpec,
                  client_loras, n_sample: int, weights=None):
        """Server aggregation: returns ``(new_lora, uplink_bytes_per_
        client)``. Default dispatches to the aggregator registry, with
        ``fed.aggregation`` overriding the method's own choice.

        Contract (kept from the JAX package, where this hook is traced
        into the jitted round program): functionally pure — don't mutate
        ``state``; values flow through ``spec``/``client_loras``; the
        uplink byte count is computable from shapes alone.

        ``weights`` (heterogeneous runs only, else ``None``) is the
        per-client ``(C,)`` coefficient vector built by
        ``heterogeneity.aggregation_weights``. Overrides must forward
        it to their aggregation rule; dropped clients arrive with an
        exact 0 and must contribute nothing."""
        name = self.fed.aggregation or self.aggregation
        kw = agg_mod.extra_kwargs(name, self.fed, n_sample)
        return agg_mod.aggregate(name, spec.lora, client_loras,
                                 weights=weights, **kw)

    def post_round(self, state: Dict[str, Any], new_lora: dict) -> dict:
        """Server-side transform of the aggregated adapters + state
        commit. The returned tree is what gets evaluated and counted as
        downlink."""
        state["lora"] = new_lora
        return new_lora

    def finalize(self, state: Dict[str, Any]) -> dict:
        """Close the run; returns the final global adapter tree."""
        return state["lora"]

    # ---- cost accounting ------------------------------------------------
    def uplink_bytes(self, per_client_up: int, n_sample: int) -> int:
        return int(per_client_up) * n_sample

    def downlink_bytes(self, new_lora: dict, n_sample: int) -> int:
        return int(agg_mod._tree_bytes(new_lora)) * n_sample

    def uplink_payload_bytes(self, spec: LocalSpec) -> int:
        """Per-client uplink payload used by the virtual wall-clock's
        transfer term (DESIGN.md §3) — must agree with the per-client
        byte count the method's aggregator reports, so sim_time and
        comm_bytes stay mutually consistent. Needed before the round
        runs (the plan's deadline/step-masks feed it), hence a
        shape-only hook."""
        return int(agg_mod._tree_bytes(spec.lora))

    def downlink_payload_bytes(self, spec: LocalSpec) -> int:
        """Per-client downlink payload for the wall-clock (mirrors
        ``downlink_bytes``' full-tree accounting)."""
        return int(agg_mod._tree_bytes(spec.lora))


class StagedStrategy(Strategy):
    """Shared scaffolding for methods that train a growing submodel on
    the developmental capacity schedule (DEVFT, ProgFed): schedule
    construction, the (stage, capacity)-per-round expansion, submodel
    round views, and the per-round submodel LoRA commit. Subclasses
    provide ``on_stage`` (build the stage submodel into
    ``state["sub"]``) and ``finalize`` (last transfer back to the
    global tree)."""

    def init_state(self, params: dict, lora: dict) -> Dict[str, Any]:
        state = super().init_state(params, lora)
        fed = self.fed
        state["sched"] = make_schedule(total_layers(self.cfg), fed.rounds,
                                       fed.n_stages, fed.growth,
                                       fed.initial_capacity)
        state["sub"] = None
        return state

    def build_rounds(self, state: Dict[str, Any]) -> List[Tuple[int, int]]:
        sched = state["sched"]
        rounds: List[Tuple[int, int]] = []
        for st, (capn, r) in enumerate(zip(sched.capacities,
                                           sched.rounds_per_stage)):
            rounds += [(st, capn)] * r
        return rounds

    def local_spec(self, state: Dict[str, Any]) -> LocalSpec:
        sub = state["sub"]
        return LocalSpec(sub.cfg, sub.params, sub.lora)

    def post_round(self, state: Dict[str, Any], new_lora: dict) -> dict:
        state["sub"] = dataclasses.replace(state["sub"], lora=new_lora)
        return new_lora
