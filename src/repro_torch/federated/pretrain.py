"""Centralized pre-training of the base model (the JAX package's
``repro.federated.pretrain``).

The paper fine-tunes *pre-trained* LLMs — layer similarity (DGLG) and
differential fusion (DBLF) are meaningful only on a structured parameter
space. For the synthetic benchmarks we therefore briefly pre-train the
reduced model on the global task (full-parameter AdamW) before handing
the frozen base to the federated methods.
"""
from __future__ import annotations

import torch

from repro_torch.interop import tree_leaves, tree_map
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import adamw_update, init_adamw


def centralized_pretrain(cfg, params, data, *, steps: int = 60,
                         batch: int = 16, seq: int = 32, lr: float = 3e-3,
                         seed: int = 0):
    """Full-parameter AdamW on noiseless global-mode batches. Returns
    (params, last loss); the input tree is left untouched."""
    opt = init_adamw(params)
    loss = None
    for i in range(steps):
        b = data.eval_batch(batch, seq, seed=(seed, i))
        p = tree_map(lambda t: t.detach().requires_grad_(True), params)
        leaves = tree_leaves(p)
        with torch.enable_grad():
            total, m = T.loss_fn(cfg, p, None, b)
            grads = torch.autograd.grad(total, leaves, allow_unused=True)
        # a leaf the loss does not reach gets a zero gradient, as in JAX
        by_leaf = {id(t): torch.zeros_like(t) if g is None else g
                   for t, g in zip(leaves, grads)}
        params, opt = adamw_update(tree_map(lambda t: by_leaf[id(t)], p),
                                   opt, params, lr)
        loss = m["loss"].detach()
    return params, float(loss) if loss is not None else None
