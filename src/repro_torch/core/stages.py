"""Developmental stage schedule — paper §2.2 / §4.1 (the JAX package's
``repro.core.stages``, pure Python, kept line for line).

The paper divides fine-tuning into S stages whose submodel capacities
form a strictly increasing sequence ending at the full depth, doubling by
default ({4,8,16,32} for LLaMA2-7B, {5,10,20,40} for 13B). Growth rate
and initial capacity are the Table 5/6 ablation knobs.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional


@dataclasses.dataclass(frozen=True)
class StageSchedule:
    capacities: List[int]            # total submodel depth per stage
    rounds_per_stage: List[int]      # federated rounds per stage

    @property
    def n_stages(self) -> int:
        return len(self.capacities)


def capacity_schedule(n_layers: int, n_stages: int = 4, growth: float = 2.0,
                      initial: Optional[int] = None) -> List[int]:
    """Capacities {L_1 < … < L_S = L}.

    Default: L_s = ceil(L / growth^(S-s)) — doubling schedule. With
    ``initial`` given (Table 5), the sequence starts there and multiplies
    by ``growth`` until reaching L (the stage count adapts).
    """
    if growth <= 1.0:
        # growth <= 1 can never reach n_layers from initial (the old
        # code spun forever in the loop below) and divides by
        # int(growth**k) == 0 in the default branch
        raise ValueError(f"growth must be > 1, got {growth}")
    if initial is not None:
        caps = [min(initial, n_layers)]
        while caps[-1] < n_layers:
            # max(.., +1) guarantees progress even when int() truncation
            # stalls (e.g. initial=1, growth=1.5 -> int(1.5) == 1)
            caps.append(min(max(int(caps[-1] * growth), caps[-1] + 1),
                            n_layers))
        return caps
    caps = []
    for s in range(1, n_stages + 1):
        c = max(1, -(-n_layers // int(growth ** (n_stages - s))))
        caps.append(min(c, n_layers))
    # enforce strict monotonicity (tiny models can collide)
    out = []
    for c in caps:
        if out and c <= out[-1]:
            c = min(out[-1] + 1, n_layers)
        out.append(c)
    out[-1] = n_layers
    return sorted(set(out)) if len(set(out)) == len(out) else _dedup(out, n_layers)


def _dedup(caps: List[int], n_layers: int) -> List[int]:
    seen, out = set(), []
    for c in caps:
        while c in seen and c < n_layers:
            c += 1
        if c not in seen:
            seen.add(c)
            out.append(c)
    out[-1] = n_layers
    return out


def make_schedule(n_layers: int, total_rounds: int, n_stages: int = 4,
                  growth: float = 2.0, initial: Optional[int] = None
                  ) -> StageSchedule:
    caps = capacity_schedule(n_layers, n_stages, growth, initial)
    s = len(caps)
    per = total_rounds // s
    rounds = [per] * s
    rounds[-1] += total_rounds - per * s
    return StageSchedule(capacities=caps, rounds_per_stage=rounds)


def allocate_stack_capacities(stack_sizes: Dict[str, int], total_cap: int
                              ) -> Dict[str, int]:
    """Distribute a stage's total capacity across heterogeneous stacks
    (hybrid / enc-dec / dense-prefix archs) proportionally to depth.

    Every non-empty stack keeps >= 1 layer; the full capacity is hit
    exactly; a stack never exceeds its own depth.
    """
    total_layers = sum(stack_sizes.values())
    n_nonempty = sum(1 for s in stack_sizes.values() if s)
    # every non-empty stack keeps >=1 layer, so that's the feasible floor
    total_cap = max(min(total_cap, total_layers), n_nonempty)
    caps = {}
    for name, sz in stack_sizes.items():
        caps[name] = min(sz, max(1, round(total_cap * sz / total_layers))) \
            if sz else 0
    # fix rounding drift
    def used():
        return sum(caps.values())
    names = [n for n, s in sorted(stack_sizes.items(),
                                  key=lambda kv: -kv[1]) if s]
    i = 0
    while used() > total_cap:
        n = names[i % len(names)]
        if caps[n] > 1:
            caps[n] -= 1
        i += 1
    i = 0
    while used() < total_cap:
        n = names[i % len(names)]
        if caps[n] < stack_sizes[n]:
            caps[n] += 1
        i += 1
    return caps
