"""Named ExperimentSpec presets (the JAX package's
``repro.experiments.presets``, the same specs).

* ``paper-appendix-b`` — the paper's App. B protocol (N=20 devices, 10%
  sampled, K=10 local steps, LoRA rank 32, DEVFT with 4 stages) on the
  reduced LLaMA2 proxy; the default base of ``repro_torch.launch.train``.
* ``bench-small`` / ``bench-tiny`` — the JAX package's benchmark-suite
  budgets.
* ``quickstart`` — the JAX package's demo run.
* ``hetero-edge`` — the heterogeneous-fleet scenario: ``bench-small``
  on the heavy-tailed ``pareto-edge`` population with partial work
  accepted at the deadline and example-count-weighted aggregation.

``register_preset`` lets downstream code add its own named specs.
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.experiments.spec import ExperimentSpec

# the reduced-model shape shared by the benchmark suites
BENCH_REDUCED = {"n_layers": 2, "d_model": 128, "n_heads": 4,
                 "n_kv_heads": 2, "d_ff": 256, "vocab": 256,
                 "n_experts": 4, "top_k": 2}

_PRESETS: Dict[str, ExperimentSpec] = {}


def register_preset(name: str, spec: ExperimentSpec) -> ExperimentSpec:
    if name in _PRESETS:
        raise ValueError(f"preset {name!r} already registered")
    _PRESETS[name] = spec
    return spec


def available_presets() -> List[str]:
    return sorted(_PRESETS)


def get_preset(name: str) -> ExperimentSpec:
    try:
        return _PRESETS[name]
    except KeyError:
        raise ValueError(f"unknown preset {name!r}; "
                         f"known: {available_presets()}") from None


register_preset("paper-appendix-b", ExperimentSpec(
    method="devft",
    rounds=24,
))

register_preset("bench-small", ExperimentSpec(
    reduced=dict(BENCH_REDUCED),
    layers=8,
    noise=0.0,
    n_clients=8, sample_frac=0.25, k_local=2, local_batch=4, seq=32,
    rounds=24, lora_rank=8, lr=1e-2, method="devft", n_stages=3,
    lr_stage_factor=2.0,          # milder than the paper's x10 at toy scale
    pretrain_steps=60,
))

register_preset("bench-tiny", get_preset("bench-small").replace(
    rounds=6, layers=4, n_stages=2,
))

register_preset("hetero-edge", get_preset("bench-small").replace(
    population="pareto-edge",
    straggler_policy="accept-partial",
    weighting="examples",
    deadline_factor=1.5,
))

register_preset("quickstart", ExperimentSpec(
    reduced={"vocab": 256},
    layers=8,
    n_clients=8, sample_frac=0.25,   # 2 clients per round
    k_local=4, local_batch=8, seq=32,
    rounds=12, lora_rank=8, lr=5e-3,
    method="devft", n_stages=3,      # capacities 2 -> 4 -> 8
))
