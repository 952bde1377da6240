"""Differential-based layer fusion (DBLF) — paper §3.3, Eq. 4–5 (the JAX
package's ``repro.core.fusion``).

Representative layer of group g with anchor a (the group's first layer):

    ϑ_g = θ_a + β · Σ_{j∈g} (θ_j − θ_a)

Ablation variants (paper Table 3): SUM (plain addition over the group)
and R-ONE (random single layer as representative).

All operations act on the leading layer axis of a stack, in the leaf's
dtype. A group's sum adds its members one at a time in layer order,
rounding after each add — what ``jax.ops.segment_sum`` does on the CPU
— and never with atomics, so the fused tensors are the JAX package's
bit for bit on the CPU (f32 and bf16) and the same on every run on the
card.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.data.synthetic import keyed_rng, seed_entropy
from repro_torch.interop import tree_map


def _segment_sum(leaf: torch.Tensor, groups) -> torch.Tensor:
    """leaf: (L, ...) -> (G, ...): each group's members summed from zero
    in layer order, in the leaf's dtype."""
    sums = []
    for g in groups:
        s = torch.zeros_like(leaf[0])
        for j in g:
            s = s + leaf[j]
        sums.append(s)
    return torch.stack(sums)


def _segment_fuse(leaf: torch.Tensor, groups, beta: float) -> torch.Tensor:
    """leaf: (L, ...) -> fused (G, ...) via Eq. 5."""
    dev = leaf.device
    anchors = torch.tensor([g[0] for g in groups], device=dev)
    counts = torch.tensor([len(g) for g in groups], device=dev)
    sums = _segment_sum(leaf, groups)
    anchor_vals = leaf[anchors]
    cnt = counts.reshape((-1,) + (1,) * (leaf.dim() - 1)).to(leaf.dtype)
    b = torch.tensor(beta, dtype=leaf.dtype, device=dev)
    return anchor_vals + b * (sums - cnt * anchor_vals)


def fuse_stack(stack: dict, groups: Sequence[Sequence[int]], beta: float,
               variant: str = "dblf", seed=0) -> dict:
    """Fuse a layer stack (nested dict, leading axis L) into (G, ...) per
    Eq. 5.

    variant: 'dblf' (paper), 'sum' (Σ θ_j), 'rone' (random member),
    'anchor' (anchor layer as-is — the β→0 limit, used by tests).
    ``seed`` (rone only) is an int or a tuple of keyed entropy.
    """
    if variant == "dblf":
        return tree_map(lambda a: _segment_fuse(a, groups, beta), stack)
    if variant == "sum":
        return tree_map(lambda a: _segment_sum(a, groups), stack)
    if variant == "rone":
        rng = keyed_rng(*seed_entropy(seed), "fusion-rone")
        picks = [g[rng.randint(len(g))] for g in groups]
        return tree_map(lambda a: a[torch.tensor(picks, device=a.device)],
                        stack)
    if variant == "anchor":
        anchors = [g[0] for g in groups]
        return tree_map(lambda a: a[torch.tensor(anchors, device=a.device)],
                        stack)
    raise ValueError(f"unknown fusion variant {variant!r}")


def layer_add(theta_i, theta_j):
    """Layer addition operation (Eq. 4, Figure 4b)."""
    return tree_map(torch.add, theta_i, theta_j)


def layer_sub(theta_j, theta_i):
    """Layer subtraction operation (Eq. 4, Figure 4c)."""
    return tree_map(torch.sub, theta_j, theta_i)
