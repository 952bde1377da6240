"""Minimal AdamW on nested dicts of tensors (the JAX package's
``repro.optim.adamw``).

Used for LoRA-only fine-tuning (paper App. B: AdamW + cosine schedule);
state exists only for the trainable (LoRA) leaves. Moments are f32 and
each updated leaf is cast back to its own dtype. Pure: returns new
tensors and leaves its inputs untouched, like the JAX version.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.interop import tree_leaves, tree_map


class AdamWState(NamedTuple):
    count: torch.Tensor          # () int32
    mu: dict
    nu: dict


def init_adamw(params) -> AdamWState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else "cpu"
    return AdamWState(count=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def adamw_update(grads, state: AdamWState, params, lr, *,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0):
    """One step. ``lr`` is a Python float or a 0-d tensor. Returns
    ``(new_params, new_state)``."""
    count = state.count + 1
    c = count.float()
    mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.float(), state.mu, grads)
    nu = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(g.float()),
                  state.nu, grads)
    bc1 = 1 - torch.pow(b1, c)
    bc2 = 1 - torch.pow(b2, c)

    def upd(p, m, v):
        step = (m / bc1) / (torch.sqrt(v / bc2) + eps) \
            + weight_decay * p.float()
        return (p.float() - lr * step).to(p.dtype)

    new_params = tree_map(upd, params, mu, nu)
    return new_params, AdamWState(count=count, mu=mu, nu=nu)
