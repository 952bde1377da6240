"""The production steps of the training and serving paths (the JAX
package's ``repro.launch.steps``), eager; each takes the MoE blocks'
``moe_path`` and the ``mesh`` it runs on (``transformer``):

* ``train_step`` — one global AdamW step on the LoRA params (frozen
  base), block checkpointing by default, CE loss;
* ``prefill_step`` — full-sequence forward, last-token logits;
* ``serve_step`` — one new token against the KV cache;
* ``federated_round_step`` — the paper's unit of work: K local steps for
  each client, then the registered server aggregation. Built from the
  same ``client.make_local_train`` and aggregation registry the
  simulator runs.

Where the JAX package ``vmap``s clients, this module loops over them:
the fused ``lora_matmul`` kernel is single-adapter, and the loop keeps
peak memory at one client's. The clients' LoRA trees are stacked on a
leading axis before ``aggregate``, as the ``vmap`` output is.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.federated import aggregation as agg_mod
from repro_torch.federated.client import make_local_train
from repro_torch.interop import tree_map
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import adamw_update


def make_train_step(cfg, *, window: Optional[int] = None,
                    moe_path: str = "gather", mesh=None,
                    remat: bool | str = True):
    """remat: True (checkpoint every block), False, or the name of a
    plain ``jax.checkpoint_policies`` policy
    (``transformer.REMAT_POLICIES``)."""
    def train_step(params, lora, opt_state, batch, lr):
        _total, metrics, grads = T.loss_and_lora_grads(
            cfg, params, lora, batch, window=window, remat=remat,
            moe_path=moe_path, mesh=mesh)
        new_lora, new_opt = adamw_update(grads, opt_state, lora, lr)
        return new_lora, new_opt, metrics

    return train_step


def make_prefill_step(cfg, *, window: Optional[int] = None,
                      moe_path: str = "gather", mesh=None):
    @torch.no_grad()
    def prefill_step(params, lora, batch):
        return T.prefill(cfg, params, lora, batch, window=window,
                         moe_path=moe_path, mesh=mesh)

    return prefill_step


def make_serve_step(cfg, *, moe_path: str = "gather", mesh=None):
    @torch.no_grad()
    def serve_step(params, lora, token, cache):
        return T.decode_step(cfg, params, lora, token, cache,
                             moe_path=moe_path, mesh=mesh)

    return serve_step


def make_federated_round_step(cfg, *, k_local: int, window=None,
                              moe_path: str = "gather", mesh=None,
                              remat: bool | str = True,
                              aggregation: str = "fedavg",
                              agg_kwargs: Optional[dict] = None,
                              hetero: bool = False):
    """One federated round: each client's K local steps, then the
    registered server aggregation. ``k_local`` is carried by the batch
    shapes ``(C, K, B, S)``.

    ``hetero=True`` takes two more arguments: per-client step masks
    ``(C, K)`` for ragged local work and the per-client aggregation
    weights ``(C,)``. Returns (new_lora, mean of the clients' last
    local losses)."""
    del k_local  # shape-carried; kept in the signature for callers
    local = make_local_train(cfg, remat=remat, window=window,
                             moe_path=moe_path, mesh=mesh)
    kw = dict(agg_kwargs or {})

    def run(params, lora, client_batches, lr, step_masks=None,
            weights=None):
        n_clients = len(client_batches["labels"])
        loras, losses = [], []
        for c in range(n_clients):
            batches = {k: v[c] for k, v in client_batches.items()}
            mask = None if step_masks is None else step_masks[c]
            new, metrics = local(params, lora, batches, lr, mask)
            loras.append(new)
            losses.append(metrics["loss_last"])
        stacked = tree_map(lambda *xs: torch.stack(xs), *loras)
        new_lora, _up = agg_mod.aggregate(aggregation, lora, stacked,
                                          weights=weights, **kw)
        return new_lora, torch.stack(losses).mean()

    if hetero:
        def round_step(params, lora, client_batches, lr, step_masks,
                       weights):
            return run(params, lora, client_batches, lr, step_masks,
                       weights)
    else:
        def round_step(params, lora, client_batches, lr):
            return run(params, lora, client_batches, lr)

    return round_step
