"""DoFIT (Xin et al. 2024) / FeDeRA-style SVD initialisation proxy (the
JAX package's ``repro.federated.methods.dofit``).

A is initialised from the top-r right singular vectors of the frozen
target weight (scaled by sqrt of the singular values), B starts at zero.
The paper's domain-aware inter-domain aggregation degenerates to this in
our single-domain synthetic setting (DESIGN.md §7); aggregation itself
is plain FedAvg.

The SVD runs in f32 on the weights' device (cuSOLVER's ``gesvd`` on the
card, an exact SVD like LAPACK's on the CPU). A singular vector is
defined up to its sign, and two libraries may pick opposite ones, so an
A column may come out negated against the JAX package's; the trained
product A·B and the losses do not depend on that choice.
"""
from __future__ import annotations

import torch

from repro_torch.federated.methods.base import AggregateContract, Strategy
from repro_torch.federated.methods.registry import register


def _svd_a(w: torch.Tensor, r: int) -> torch.Tensor:
    """(L, d_in, d_out) weights -> (L, d_in, r) f32: each layer's top-r
    right singular vectors, scaled by sqrt of their singular values.
    Contiguous, as the ``lora_matmul`` kernel takes its factors."""
    # cuSOLVER's QR-iteration SVD on the card (the CPU takes no choice)
    _u, s, vt = torch.linalg.svd(w.float(), full_matrices=False,
                                 driver="gesvd" if w.is_cuda else None)
    a = vt[:, :r].transpose(1, 2) * torch.sqrt(s[:, None, :r])
    return a.contiguous()


def svd_init_lora(params: dict, lora: dict) -> dict:
    """A <- top-r right singular vectors of the frozen target weight."""
    new = {}
    for name, stack in lora.items():
        tgt = {}
        for t, ab in stack.items():
            w = params["blocks"][name]["mixer"].get(t)
            if w is None:
                tgt[t] = ab
                continue
            r = ab["a"].shape[-1]
            tgt[t] = {"a": _svd_a(w, r).to(ab["a"].dtype),
                      "b": torch.zeros_like(ab["b"])}
        new[name] = tgt
    return new


@register()
class DoFIT(Strategy):
    name = "dofit"
    description = "SVD-initialised LoRA + FedAvg (Xin et al. 2024 proxy)"
    aggregation = "fedavg"
    contract = AggregateContract(uplink="full")

    def init_lora(self, params: dict, lora: dict) -> dict:
        return svd_init_lora(params, lora)
