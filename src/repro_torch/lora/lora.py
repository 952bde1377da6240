"""LoRA utilities: leaf roles, merging, byte accounting.

LoRA init/application lives with the model
(``repro_torch.models.transformer`` / ``layers._proj``); these are the
server-side utilities the serving and federated paths use.
"""
from __future__ import annotations

import math

import torch

from repro_torch.interop import tree_leaves


def lora_leaf_role(path) -> "str | None":
    """Classify a key path (tuple of dict keys) into a LoRA tree: ``'a'``
    (down-projection), ``'b'`` (up-projection), or ``None``. The
    canonical tree is ``{stack: {target: {'a': (L, d, r), 'b': (L, r,
    out)}}}``; the innermost key names the factor."""
    for key in reversed(tuple(path)):
        if key in ("a", "b"):
            return key
    return None


def is_lora_a(path) -> bool:
    return lora_leaf_role(path) == "a"


def is_lora_b(path) -> bool:
    return lora_leaf_role(path) == "b"


def merge_lora(params: dict, lora: dict, scaling: "float | None" = None
               ) -> dict:
    """Fold LoRA adapters into the base weights (removes the rank-r
    bypass matmuls from every decode step). ``scaling=None`` derives
    alpha/r per target via ``layers.lora_scaling``, the rule the forward
    pass applies. Returns a new params tree; the input is untouched."""
    from repro_torch.models.layers import lora_scaling

    new_blocks = {}
    for name, stack in params["blocks"].items():
        if name not in lora:
            new_blocks[name] = stack
            continue
        stack = dict(stack)
        mixer = dict(stack["mixer"])
        for target, ab in lora[name].items():
            sc = scaling if scaling is not None else lora_scaling(ab)
            delta = torch.einsum("lir,lro->lio", ab["a"], ab["b"]) * sc
            mixer[target] = mixer[target] + delta.to(mixer[target].dtype)
        stack["mixer"] = mixer
        new_blocks[name] = stack
    out = dict(params)
    out["blocks"] = new_blocks
    return out


def lora_bytes(lora: dict) -> int:
    return int(sum(math.prod(l.shape) * l.element_size()
                   for l in tree_leaves(lora)))


def lora_param_count(lora: dict) -> int:
    return int(sum(math.prod(l.shape) for l in tree_leaves(lora)))
