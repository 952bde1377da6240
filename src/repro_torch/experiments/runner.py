"""run_experiment — the single entry point the training CLI routes
through (the JAX package's ``repro.experiments.runner``).

``run_experiment(spec)`` materializes the model config, the synthetic
federated data, and (when ``spec.pretrain_steps > 0``) the shared
pre-trained base, then runs the method-agnostic round engine and returns
a structured :class:`RunResult`.

The pre-trained-base cache is keyed on ``spec.base_key(device)`` and the
device and dtype, so specs that differ only in method/rounds/aggregation
share one base, while any change to the model or pretrain setup is a
miss.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.data.synthetic import make_federated_data
from repro_torch.experiments.results import RunResult, summarize
from repro_torch.experiments.spec import ExperimentSpec
from repro_torch.federated.simulator import FederatedRunner
from repro_torch.interop import tree_map

_BASE_CACHE: Dict[tuple, Tuple] = {}


def clear_base_cache() -> None:
    _BASE_CACHE.clear()


def pretrained_base(spec: ExperimentSpec, *, device="cuda",
                    dtype=torch.float32):
    """(params, pretrain_loss) for this spec's base model, initialized
    from ``spec.seed`` by a ``torch.Generator`` on ``device`` and cached
    (DESIGN.md §7: the paper fine-tunes *pretrained* models, so
    benchmarks briefly pre-train on a disjoint corpus)."""
    key = (spec.base_key(device), str(torch.device(device)), str(dtype))
    if key not in _BASE_CACHE:
        from repro_torch.federated.pretrain import centralized_pretrain
        from repro_torch.models import transformer as T

        cfg = spec.build_cfg()
        gen = torch.Generator(device=device).manual_seed(spec.seed)
        params = T.init_params(cfg, gen, dtype)
        if spec.homogeneous_init:
            # identical-layer init: the functional-homogeneity regime of
            # large pretrained LLMs that DGLG/DBLF assume
            params["blocks"] = tree_map(
                lambda a: a[:1].expand(a.shape).contiguous(),
                params["blocks"])
        # pre-train on a DIFFERENT task (generic "pre-training corpus"),
        # fine-tune federatedly on the real one — else there is nothing
        # left to adapt
        pre_data = make_federated_data(cfg.vocab,
                                       n_clients=spec.n_clients,
                                       alpha=0.5, noise=0.0,
                                       seed=(spec.seed, "pretrain-corpus"))
        params, loss = centralized_pretrain(
            cfg, params, pre_data, steps=spec.pretrain_steps,
            batch=16, seq=spec.seq, lr=3e-3, seed=spec.seed)
        _BASE_CACHE[key] = (params, loss)
    return _BASE_CACHE[key]


def run_experiment(spec: ExperimentSpec, *,
                   round_progress: Optional[Callable] = None,
                   data=None, params=None, lora=None,
                   export_adapters: bool = False, device="cuda",
                   dtype=torch.float32) -> RunResult:
    """Run one spec end-to-end on ``device``. ``round_progress(RoundLog)``
    fires after every round. ``data``/``params``/``lora`` are escape
    hatches for callers that already hold them (tests hand in the JAX
    package's, through ``repro_torch.interop``); by default all derive
    from the spec. ``dtype`` is the params' dtype when they are
    initialized here (the JAX package's ``FederatedRunner`` default,
    f32; the LoRA is f32 whatever it is).

    ``export_adapters=True`` closes the train->serve loop: the result's
    ``adapter_registry`` holds the aggregated global adapter plus one
    personalized adapter per client (a few local steps on each client's
    own data), ready to pass to ``repro_torch.serving.ServingEngine``."""
    if spec.mesh not in (None, "none"):
        raise NotImplementedError(
            f"mesh={spec.mesh!r}: the port's round engine runs on one "
            f"device (ROADMAP.md, tooling)")
    cfg = spec.build_cfg()
    pretrain_loss = None
    if params is None and spec.pretrain_steps:
        params, pretrain_loss = pretrained_base(spec, device=device,
                                                dtype=dtype)
    if data is None:
        data = make_federated_data(cfg.vocab, n_clients=spec.n_clients,
                                   alpha=spec.alpha, noise=spec.noise,
                                   seed=spec.seed)
    runner = FederatedRunner(cfg, spec.fed_config(), data, dtype=dtype,
                             params=params, lora=lora, device=device)
    t0 = time.time()
    logs = runner.run(round_progress)
    wall = time.time() - t0
    result = RunResult(spec=spec, logs=logs, wall_s=wall,
                       metrics=summarize(logs, wall),
                       pretrain_loss=pretrain_loss,
                       final_lora=runner.lora)
    if export_adapters:
        from repro_torch.serving import registry_from_run
        result.adapter_registry = registry_from_run(result, runner.params,
                                                    data)
    return result
