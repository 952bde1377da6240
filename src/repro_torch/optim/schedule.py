"""LR schedules: cosine (paper App. B), the paper's staged ×10 ramp,
and WSD (warmup-stable-decay — MiniCPM's schedule, exposed because
minicpm-2b is one of the assigned architectures)."""
from __future__ import annotations

import math


def cosine(step: int, total: int, base_lr: float, min_frac: float = 0.1
           ) -> float:
    t = min(max(step, 0), max(total, 1)) / max(total, 1)
    return base_lr * (min_frac + (1 - min_frac) * 0.5 * (1 + math.cos(math.pi * t)))


def staged_lr(stage: int, *, lr0: float = 1e-6, factor: float = 10.0,
              cap: float = 1e-4) -> float:
    """Paper App. B: start 1e-6, ×10 per stage, capped at 1e-4."""
    return min(lr0 * factor ** stage, cap)


def staged_cosine(stage: int, step_in_stage: int, steps_per_stage: int,
                  **kw) -> float:
    return cosine(step_in_stage, steps_per_stage, staged_lr(stage, **kw))


def wsd(step: int, total: int, base_lr: float, warmup_frac: float = 0.1,
        decay_frac: float = 0.1, min_frac: float = 0.01) -> float:
    """Warmup-Stable-Decay (MiniCPM, arXiv:2404.06395)."""
    w = int(total * warmup_frac)
    d = int(total * decay_frac)
    if step < w:
        return base_lr * step / max(w, 1)
    if step < total - d:
        return base_lr
    rem = (total - step) / max(d, 1)
    return base_lr * max(min_frac, rem)
