"""Grid sweeps over ExperimentSpecs with multi-seed aggregation (the JAX
package's ``repro.experiments.sweep``).

``sweep(base, axes)`` expands a cartesian grid of spec-field overrides
(× seeds) and runs each through ``run_experiment``; ``sweep_cases``
takes an explicit list of override dicts for non-cartesian grids (e.g.
Table 4's paired method×aggregation rows). ``aggregate_seeds`` folds a
result list into per-case mean/std over the seed axis. ``device`` and
``dtype`` go to every ``run_experiment`` call.
"""
from __future__ import annotations

import itertools
import math
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, \
    Union

import torch

from repro_torch.data.synthetic import derived_seeds
from repro_torch.experiments.results import RunResult
from repro_torch.experiments.runner import run_experiment
from repro_torch.experiments.spec import ExperimentSpec

Axes = Mapping[str, Sequence[Any]]
Case = Dict[str, Any]


def expand_cases(axes: Optional[Axes]) -> List[Case]:
    """Cartesian product of axis values, in axis insertion order."""
    if not axes:
        return [{}]
    keys = list(axes)
    return [dict(zip(keys, combo))
            for combo in itertools.product(*(axes[k] for k in keys))]


def _seed_list(base: ExperimentSpec,
               seeds: Union[int, Sequence[int]]) -> List[int]:
    """Replicate seeds for ``seeds=n``: the spec's own seed first, then
    ``n - 1`` ``SeedSequence``-derived seeds keyed on it (``base + i``
    arithmetic collides across bases: base 0 seed 3 == base 3 seed 0)."""
    if isinstance(seeds, int):
        n_replicates = int(seeds)   # a count, not a seed
        out = [base.seed]
        out.extend(derived_seeds(max(0, n_replicates - 1),
                                 base.seed, "sweep"))
        return out
    return list(seeds)


def expand_specs(base: ExperimentSpec, axes: Optional[Axes] = None, *,
                 cases: Optional[Sequence[Case]] = None,
                 seeds: Union[int, Sequence[int]] = 1
                 ) -> List[ExperimentSpec]:
    """All (case × seed) specs for a sweep. ``axes`` expands to a
    cartesian grid; ``cases`` is used verbatim; giving both is an
    error."""
    if axes and cases:
        raise ValueError("pass either axes or cases, not both")
    expanded = list(cases) if cases is not None else expand_cases(axes)
    out = []
    for case in expanded:
        if "seed" in case:
            # an explicit seed axis/case IS the seed expansion
            out.append(base.replace(**case))
        else:
            for seed in _seed_list(base, seeds):
                out.append(base.replace(seed=seed, **case))
    return out


def sweep(base: ExperimentSpec, axes: Optional[Axes] = None, *,
          cases: Optional[Sequence[Case]] = None,
          seeds: Union[int, Sequence[int]] = 1,
          progress: Optional[Callable] = None,
          round_progress: Optional[Callable] = None,
          device="cuda", dtype=torch.float32) -> List[RunResult]:
    """Run the whole grid on ``device``. ``progress(i, n, spec)`` is
    called before each run; ``round_progress(RoundLog)`` is forwarded to
    the engine."""
    specs = expand_specs(base, axes, cases=cases, seeds=seeds)
    results = []
    for i, spec in enumerate(specs):
        if progress:
            progress(i, len(specs), spec)
        results.append(run_experiment(spec, round_progress=round_progress,
                                      device=device, dtype=dtype))
    return results


def sweep_cases(base: ExperimentSpec, cases: Sequence[Case], *,
                seeds: Union[int, Sequence[int]] = 1,
                progress: Optional[Callable] = None,
                round_progress: Optional[Callable] = None,
                device="cuda", dtype=torch.float32) -> List[RunResult]:
    return sweep(base, cases=cases, seeds=seeds, progress=progress,
                 round_progress=round_progress, device=device, dtype=dtype)


def aggregate_seeds(results: Sequence[RunResult]) -> List[Dict[str, Any]]:
    """Group results by everything-but-seed and fold the numeric metrics
    to mean/std. Returns one dict per case, in first-seen order:
    ``{"spec", "seeds", "n_seeds", "metrics": {name: {mean, std}}}``.
    Non-numeric metrics (e.g. the formatted ``flops`` string) keep the
    first seed's value."""
    groups: Dict[str, List[RunResult]] = {}
    order: List[str] = []
    for r in results:
        key = r.spec.replace(seed=0).spec_hash()
        if key not in groups:
            groups[key] = []
            order.append(key)
        groups[key].append(r)
    out = []
    for key in order:
        rs = groups[key]
        metrics: Dict[str, Any] = {}
        for name in rs[0].metrics:
            vals = [r.metrics[name] for r in rs]
            if all(isinstance(v, (int, float)) and not isinstance(v, bool)
                   for v in vals):
                mean = sum(vals) / len(vals)
                var = sum((v - mean) ** 2 for v in vals) / len(vals)
                metrics[name] = {"mean": round(mean, 6),
                                 "std": round(math.sqrt(var), 6)}
            else:
                metrics[name] = vals[0]
        out.append({"spec": rs[0].spec,
                    "seeds": [r.spec.seed for r in rs],
                    "n_seeds": len(rs), "metrics": metrics})
    return out
