"""Cross-stage knowledge transfer — paper §3.4 / Eq. 12 (the JAX
package's ``repro.core.transfer``).

After stage s, the trained submodel's representative layers update the
global model: every layer j in group g_n inherits the LoRA parameters of
representative layer n ("functionally similar layers inherently exhibit
similar parameter distributions"). Only LoRA parameters are updated —
base weights stay frozen throughout (paper §3.4).
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core.grouping import labels_from_groups
from repro_torch.interop import tree_map


def broadcast_lora(sub_lora_stack: dict, groups: Sequence[Sequence[int]],
                   n_layers: int) -> dict:
    """Expand a trained submodel LoRA stack (G, ...) back to (L, ...)."""
    labels = torch.from_numpy(labels_from_groups(groups, n_layers))
    return tree_map(lambda a: a[labels.to(a.device)], sub_lora_stack)


def transfer_stage(global_lora: dict, sub_lora: dict,
                   plan: "dict[str, dict]") -> dict:
    """Update the global LoRA tree from a finished stage.

    plan: {stack_name: {'groups': [[...]], 'n_layers': L}} — produced by
    ``repro_torch.core.devft.build_submodel``.
    """
    new = dict(global_lora)
    for name, info in plan.items():
        if name not in global_lora:
            continue
        new[name] = broadcast_lora(sub_lora[name], info["groups"],
                                   info["n_layers"])
    return new
