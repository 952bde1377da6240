"""Client-side local training: K local AdamW steps on LoRA params only
(the JAX package's ``repro.federated.client``).

Ragged local work (heterogeneous clients): an optional ``step_mask`` of
shape ``(K,)`` realizes a per-client step count ``k_c <= K`` with fixed
shapes — every step still runs the forward and backward, but masked
steps leave the adapters and the optimizer state untouched
(``torch.where`` on the device, no host branch, so an all-ones mask
gives the unmasked result). The metrics carry the client's processed
label-token count for weighted aggregation.
"""
from __future__ import annotations

import torch

from repro_torch.interop import tree_leaves, tree_map
from repro_torch.models.transformer import loss_and_lora_grads
from repro_torch.optim.adamw import AdamWState, adamw_update, init_adamw


def _keep(keep: torch.Tensor, new, old):
    return tree_map(lambda n, o: torch.where(keep, n, o), new, old)


def make_local_train(cfg, *, remat: bool | str = False, window=None,
                     moe_path: str = "gather", mesh=None):
    """Returns local_train(params, lora, batches, lr, step_mask=None)
    -> (lora', metrics).

    batches: {'tokens': (K, B, S), 'labels': (K, B, S)} (numpy or
    tensors; moved to the params' device here) — K local steps (paper
    App. B: K=10, batch 16). The optimizer state is reset at every call
    (stateless-client FedAvg, matching OpenFedLLM). The params are frozen
    (no gradient); the LoRA leaves are differentiated as f32 leaves and
    returned as new tensors, the inputs untouched.

    metrics: ``loss_first`` / ``loss_last`` (the losses of steps 0 and
    K-1, masked or not) and ``n_examples`` (label tokens trained on).
    ``moe_path`` and ``mesh`` go to the model (``transformer.loss_fn``).
    (The JAX package's ``lr_is_input`` flag, which it never reads, is
    not carried over.)
    """

    def local_train(params, lora, batches, lr, step_mask=None):
        dev = tree_leaves(params)[0].device
        batches = {k: torch.as_tensor(v).to(dev) for k, v in batches.items()}
        k_steps, b, s = batches["labels"].shape[:3]
        mask = None if step_mask is None \
            else torch.as_tensor(step_mask).to(dev, torch.float32)
        opt = init_adamw(lora)
        losses = []
        for t in range(k_steps):
            batch = {k: v[t] for k, v in batches.items()}
            _total, metrics, grads = loss_and_lora_grads(
                cfg, params, lora, batch, window=window, remat=remat,
                moe_path=moe_path, mesh=mesh)
            new_lora, new_opt = adamw_update(grads, opt, lora, lr,
                                             weight_decay=0.0)
            if mask is not None:
                keep = mask[t] > 0
                new_lora = _keep(keep, new_lora, lora)
                new_opt = AdamWState(
                    count=torch.where(keep, new_opt.count, opt.count),
                    mu=_keep(keep, new_opt.mu, opt.mu),
                    nu=_keep(keep, new_opt.nu, opt.nu))
            lora, opt = new_lora, new_opt
            losses.append(metrics["loss"])
        if mask is None:
            n_examples = torch.tensor(float(k_steps * b * s), device=dev)
        else:
            n_examples = mask.sum() * (b * s)
        return lora, {"loss_first": losses[0], "loss_last": losses[-1],
                      "n_examples": n_examples}

    return local_train
