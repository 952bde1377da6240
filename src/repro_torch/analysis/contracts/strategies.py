"""C002 — strategy round-program contracts (the JAX package's
``contracts/strategies.py``).

Enumerates every registered Strategy × every ExperimentSpec preset ×
every device fleet × every straggler policy, walks the strategy's real
lifecycle on the host (``init_lora``/``init_state``/``build_rounds``/
``on_stage``/``local_spec`` on real CPU trees — staged methods get every
stage), and runs the round program on ``meta`` tensors as the runner's
``federated.simulator.make_round_program`` runs it without a mesh: each
client's K local steps, then the strategy's ``aggregate`` on their
stack, with the heterogeneous step-mask and weight operands whenever the
fleet × policy cell runs the heterogeneous round. Checked per program:

* the aggregated adapter tree carries exactly the shapes and dtypes of
  the incoming global tree (``AggregateContract.preserves_adapter_
  avals``);
* the per-client uplink byte count is a positive Python int, computed
  from shapes, not a tensor.

The JAX checker also checks the round's per-client metrics; the port's
round program returns none (JAX's runner discards them too).

Fleet × policy cells that run the same program are deduplicated after
being enumerated, as the JAX package's ``_hetero_cells`` does; ``stats``
reports both numbers. Programs are told apart by the sub-model's config
(the port has no ``cache_key``) and the round's shapes.

On meta tensors a client's local training gives outputs that depend only
on the config and its inputs' shapes and dtypes, so the clients of a
program, and the programs with the same config and inputs, share one run
of it; each strategy's ``aggregate`` runs on their stack.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.analysis.contracts.base import (avals_of, contract_finding,
                                                 leaf_mismatches)
from repro_torch.analysis.findings import Finding
from repro_torch.interop import tree_map, tree_paths

PATH = "src/repro_torch/federated/methods/registry.py"
HINT = ("the aggregated tree must carry the incoming global adapters' "
        "shapes and dtypes and the uplink must be a Python int (see "
        "AggregateContract in methods/base.py); declare `contract = "
        "AggregateContract(...)` in the class body")

META = torch.device("meta")


def _hetero_cells(fed, fleets, policies) -> Dict[bool, List[str]]:
    """Map heterogeneous-round flag -> the fleet×policy cells that run
    it (mirrors FederatedRunner's ``_hetero`` gate)."""
    from repro_torch.federated.heterogeneity import make_population

    cells: Dict[bool, List[str]] = {}
    for fleet in fleets:
        pop = make_population(fleet, fed.n_clients, fed.seed)
        for policy in policies:
            deadline_can_bind = (policy != "wait"
                                 and fed.deadline_factor <= 1.0)
            flag = ((not pop.is_reference)
                    or fed.weighting != "uniform" or deadline_can_bind)
            cells.setdefault(flag, []).append(f"{fleet}/{policy}")
    return cells


def round_operands(spec_l, fed, n_sample, hetero):
    """Meta operands of the round program: ``(params, lora, batches,
    lr)``, plus ``(masks, weights)`` for the heterogeneous round."""
    c, k = n_sample, fed.k_local
    b, s = fed.local_batch, fed.seq
    tokens = torch.empty((c, k, b, s), dtype=torch.int32, device=META)
    batches = {"tokens": tokens, "labels": torch.empty_like(tokens)}
    args = (avals_of(spec_l.params), avals_of(spec_l.lora), batches,
            float(fed.lr))
    if hetero:
        args += (torch.empty((c, k), device=META),
                 torch.empty((c,), device=META))
    return args


def _signature(tree):
    return tuple((path, tuple(t.shape), t.dtype)
                 for path, t in tree_paths(tree))


def _trace_round(strategy, state, spec_l, fed, n_sample, hetero, runs):
    """One round program on meta tensors -> ``(new_lora, up, incoming
    lora)``. ``runs`` holds the clients' local-training outputs by
    config and input signature, shared across calls."""
    from repro_torch.federated.client import make_local_train
    from repro_torch.federated.methods.base import LocalSpec

    params, lora, batches, lr, *het = round_operands(spec_l, fed, n_sample,
                                                     hetero)
    masks, weights = het or (None, None)
    one = {k: v[0] for k, v in batches.items()}
    key = (spec_l.cfg, hetero, _signature(params), _signature(lora),
           _signature(one))
    if key not in runs:
        runs[key], _ = make_local_train(spec_l.cfg)(
            params, lora, one, lr, None if masks is None else masks[0])
    stacked = tree_map(lambda t: torch.stack([t] * n_sample), runs[key])
    new_lora, up = strategy.aggregate(
        state, LocalSpec(spec_l.cfg, params, lora), stacked, n_sample,
        weights=weights)
    return new_lora, up, lora


def _init_model(cfg, fed):
    """Real CPU trees from ``fed.seed`` (the host lifecycle reads
    values: DoFIT's SVD, DevFT's grouping)."""
    from repro_torch.models import transformer as T

    gen = torch.Generator().manual_seed(fed.seed)
    params = T.init_params(cfg, gen, torch.float32)
    lora = T.init_lora(cfg, gen, rank=fed.lora_rank)
    return params, lora


def check_strategies() -> Tuple[List[Finding], Dict[str, int]]:
    from repro_torch.federated.methods.registry import available_methods

    findings: List[Finding] = []
    models: Dict = {}           # (cfg, rank, seed) -> (params, lora)
    traced: Dict = {}           # program key -> surface that ran it
    runs: Dict = {}             # local-training key -> meta adapters
    counts = {"pairs": 0, "cells": 0}
    methods = available_methods()
    for method in methods:
        findings += _check_method(method, models, traced, runs, counts)
    stats = {"strategies": len(methods),
             "strategy_presets": counts["pairs"],
             "strategy_cells": counts["cells"],
             "strategy_programs": len(traced)}
    return findings, stats


def _check_method(method, models, traced, runs, counts) -> List[Finding]:
    """One strategy over every preset, stage and distinct fleet×policy
    program; adds the (strategy, preset) pairs and fleet×policy cells it
    walked to ``counts``."""
    from repro_torch.experiments.presets import available_presets, get_preset
    from repro_torch.federated.heterogeneity import (POLICIES,
                                                     available_fleets)
    from repro_torch.federated.methods.base import AggregateContract
    from repro_torch.federated.methods.registry import (get_strategy,
                                                        make_strategy)

    # the contract must be declared in the registered class's own body:
    # inheriting the base default silently is the drift R010 catches, so
    # the contract layer enforces it too
    declared = vars(get_strategy(method)).get("contract")
    if not isinstance(declared, AggregateContract):
        return [contract_finding(
            "C002", PATH, f"strategy:{method}",
            f"registered strategy {method!r} declares no "
            f"AggregateContract in its class body", HINT)]

    findings: List[Finding] = []
    for preset in available_presets():
        spec = get_preset(preset).replace(method=method)
        cfg = spec.build_cfg()
        fed = spec.fed_config()
        cells = _hetero_cells(fed, available_fleets(), POLICIES)
        counts["pairs"] += 1
        counts["cells"] += sum(len(v) for v in cells.values())
        n_sample = max(1, int(fed.n_clients * fed.sample_frac))

        mkey = (cfg, fed.lora_rank, fed.seed)
        if mkey not in models:
            models[mkey] = _init_model(cfg, fed)
        params, lora0 = models[mkey]
        strategy = make_strategy(method, cfg, fed)
        lora = strategy.init_lora(params, lora0)
        state = strategy.init_state(params, lora)
        rounds = strategy.build_rounds(state)
        for stage in dict.fromkeys(st for st, _ in rounds):
            strategy.on_stage(state, stage)
            spec_l = strategy.local_spec(state)
            for hetero in sorted(cells):
                pkey = (method, spec_l.cfg, hetero, n_sample, fed.k_local,
                        fed.local_batch, fed.seq, fed.aggregation,
                        fed.lora_rank)
                if pkey in traced:
                    continue
                surface = (f"strategy:{method}:{preset}:stage{stage}:"
                           f"{'hetero' if hetero else 'uniform'}")
                traced[pkey] = surface
                findings += _check_round(declared, strategy, state, spec_l,
                                         fed, n_sample, hetero, surface,
                                         runs)
    return findings


def _check_round(declared, strategy, state, spec_l, fed, n_sample, hetero,
                 surface, runs) -> List[Finding]:
    def found(msg):
        return contract_finding("C002", PATH, surface, msg, HINT)

    try:
        new_lora, up, incoming = _trace_round(
            strategy, state, spec_l, fed, n_sample, hetero, runs)
    except Exception as e:      # a failed run is itself a violation
        return [found(f"round program failed on meta tensors: "
                      f"{type(e).__name__}: {e}")]
    out = []
    if declared.preserves_adapter_avals:
        out += [found(f"aggregated tree drifts from the global adapters' "
                      f"shapes and dtypes ({msg})")
                for msg in leaf_mismatches(incoming, new_lora, "new_lora")]
    if not isinstance(up, (int, np.integer)) or isinstance(up, bool) \
            or up <= 0:
        out.append(found(f"uplink byte count must be a positive Python "
                         f"int computed from shapes, got "
                         f"{type(up).__name__}: {up!r}"))
    return out
