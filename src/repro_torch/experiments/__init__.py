"""Declarative experiment API — the front door of the port's training
path (the JAX package's ``repro.experiments``).

    from repro_torch.experiments import ExperimentSpec, run_experiment

    spec = ExperimentSpec(method="devft", rounds=8, n_clients=8)
    result = run_experiment(spec)          # -> RunResult

``launch/train.py`` (CLI) routes through :func:`run_experiment`;
``sweep``/``sweep_cases`` run grids of specs through it.
"""
from repro_torch.experiments.presets import (  # noqa: F401
    available_presets,
    get_preset,
    register_preset,
)
from repro_torch.experiments.results import (  # noqa: F401
    RunResult,
    rounds_to_target,
    summarize,
    time_to_target,
)
from repro_torch.experiments.runner import (  # noqa: F401
    clear_base_cache,
    pretrained_base,
    run_experiment,
)
from repro_torch.experiments.spec import (  # noqa: F401
    SCHEMA_VERSION,
    ExperimentSpec,
)
from repro_torch.experiments.sweep import (  # noqa: F401
    aggregate_seeds,
    expand_cases,
    expand_specs,
    sweep,
    sweep_cases,
)
