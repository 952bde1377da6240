"""The floating-point operations of a round, from the configuration's
reference module's ``per_token`` (see ``fedbench.reference``): what a
token takes forward and backward through the round's (sub)model."""
from __future__ import annotations

from types import ModuleType
from typing import Dict


def round_flops(reference: ModuleType, m: dict, sizes: Dict[str, int],
                spec: dict, n_sample: int, eval_rows: int, r: int) -> float:
    """One round: every sampled client's K steps and the eval forward."""
    s = spec["seq"]
    fwd, bwd = reference.per_token(m, sizes, s, r)
    train = n_sample * spec["k_local"] * spec["local_batch"] * s * (fwd + bwd)
    return train + eval_rows * s * fwd
