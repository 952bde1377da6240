"""Server-side aggregation rules (an open registry), the JAX package's
``repro.federated.aggregation`` on trees of tensors.

* ``fedavg`` — FedIT (Zhang et al. 2024): plain mean of client LoRA.
* ``fedsa``  — FedSA-LoRA (Guo et al. 2024): only the A matrices are
  shared/aggregated; B stays local (the global B is the client mean, as
  an evaluation surrogate) and the uplink counts A's bytes only.
* ``flora``  — FLoRA (Wang et al. 2024) proxy: clients hold
  heterogeneous ranks; updates are zero-masked beyond each client's
  rank before averaging.

Each aggregator takes the incoming global LoRA tree and the clients'
trees stacked on a leading client axis, and returns ``(new_global_lora,
uplink_bytes_per_client)``; the byte count is a Python int.

Weighted aggregation (heterogeneous clients): every built-in accepts an
optional per-client coefficient vector ``weights`` (shape ``(C,)``) and
computes ``new = g + sum_c w_c * (x_c - g)``, so zero-weight clients
contribute nothing and if ``sum w < 1`` the missing mass stays on the
incoming global adapters. ``weights=None`` is the unweighted rule.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import torch

from repro_torch.interop import tree_leaves, tree_map, tree_paths
from repro_torch.lora import is_lora_a


def _tree_bytes(tree) -> int:
    return int(sum(t.numel() * t.element_size() for t in tree_leaves(tree)))


def _a_bytes(tree) -> int:
    """Bytes of the LoRA A matrices only (the FedSA-LoRA payload)."""
    return int(sum(t.numel() * t.element_size()
                   for path, t in tree_paths(tree) if is_lora_a(path)))


def _map_with_path(fn, tree, other, path=()):
    """``fn(path, leaf, other_leaf)`` over two trees of one structure."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, tree[k], other[k], path + (k,))
                for k in tree}
    return fn(path, tree, other)


def _as_weights(weights, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(weights).to(device=like.device, dtype=like.dtype)


def _mean_over_clients(stacked):
    return tree_map(lambda a: a.mean(dim=0), stacked)


def _weighted_combine(global_lora, stacked, weights):
    """``new = g + sum_c w_c (x_c - g)`` per leaf; ``weights`` is the
    (C,) coefficient vector (already normalized by the caller's
    weighting rule — zero rows drop clients, sum w < 1 keeps mass on g)."""
    def comb(g, s):
        w = _as_weights(weights, s).reshape((-1,) + (1,) * (s.dim() - 1))
        return g + torch.sum(w * (s - g[None]), dim=0)

    return tree_map(comb, global_lora, stacked)


def fedavg(global_lora, client_loras_stacked, weights=None):
    """client_loras_stacked: tree with a leading client axis."""
    if weights is None:
        new = _mean_over_clients(client_loras_stacked)
    else:
        new = _weighted_combine(global_lora, client_loras_stacked, weights)
    return new, _tree_bytes(global_lora)


def fedsa(global_lora, client_loras_stacked, weights=None):
    """Share/aggregate only LoRA A matrices (B's mean is the global
    model's evaluation surrogate and does not count as uplink)."""
    if weights is None:
        new = _mean_over_clients(client_loras_stacked)
    else:
        new = _weighted_combine(global_lora, client_loras_stacked, weights)
    return new, _a_bytes(global_lora)


def flora_pad(global_lora, client_loras_stacked, client_ranks: Sequence[int],
              weights=None):
    """Heterogeneous-rank averaging: client c's update is masked beyond its
    rank, then a rank-weighted mean is taken. With ``weights``, the rank
    mask scales each client's coefficient in the delta form
    ``new = g + sum_c w_c * mask_c * (x_c - g)`` — not a renormalized
    mean, so rank columns no kept client reaches stay at the incoming
    global value."""
    def agg(path, g, stacked):
        ranks = torch.as_tensor(list(client_ranks), device=stacked.device)
        is_a = is_lora_a(path)
        r_axis = stacked.dim() - 1 if is_a else stacked.dim() - 2
        r_full = stacked.shape[r_axis]
        m = ranks[:, None] > torch.arange(r_full, device=stacked.device)[None]
        shape = [stacked.shape[0]] + [1] * (stacked.dim() - 1)
        shape[r_axis] = r_full
        mask = m.reshape(shape).to(stacked.dtype)
        if weights is not None:
            w = _as_weights(weights, stacked).reshape(
                (-1,) + (1,) * (stacked.dim() - 1))
            return g + torch.sum(mask * w * (stacked - g[None]), dim=0)
        num = torch.sum(stacked * mask, dim=0)
        den = torch.clamp(torch.sum(mask, dim=0), min=1.0)
        return num / den

    new = _map_with_path(agg, global_lora, client_loras_stacked)
    return new, _tree_bytes(global_lora)  # upper bound; scales by rank


def default_flora_ranks(server_rank: int, n_clients: int) -> List[int]:
    """Deterministic heterogeneous-rank spread r/(1+c%4) used when
    ``FedConfig.flora_ranks`` is unset."""
    return [server_rank // (1 + c % 4) for c in range(n_clients)]


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_AGGREGATORS: Dict[str, Callable] = {}
_CANONICAL: List[str] = []


def register_aggregator(name: str, fn: Callable,
                        aliases: Sequence[str] = ()) -> None:
    keys = (name, *aliases)
    taken = [k for k in keys if k in _AGGREGATORS]
    if taken:   # validate every key before mutating anything
        raise ValueError(f"aggregator name(s) already registered: {taken}")
    for key in keys:
        _AGGREGATORS[key] = fn
    _CANONICAL.append(name)


def available_aggregations() -> List[str]:
    """Canonical rule names only — aliases (``fedit`` -> ``fedavg``)
    still resolve in ``aggregate()`` but are not advertised."""
    return sorted(_CANONICAL)


# method-name aliases: ``aggregation="fedit"`` / ``"devft"`` mean FedAvg
register_aggregator("fedavg", fedavg, aliases=("fedit", "devft"))
register_aggregator("fedsa", fedsa, aliases=("fedsa-lora",))
register_aggregator("flora", flora_pad)


def extra_kwargs(method: str, fed, n_sample: int) -> Dict:
    """Per-aggregator keyword arguments derived from the run config
    (duck-typed ``FedConfig``: ``flora_ranks``, ``lora_rank``)."""
    if _AGGREGATORS.get(method) is flora_pad:
        if fed.flora_ranks:
            ranks = list(fed.flora_ranks)
            if len(ranks) < n_sample:
                raise ValueError(
                    f"flora_ranks has {len(ranks)} entries but "
                    f"{n_sample} clients are sampled per round; provide "
                    f"one rank per sampled client")
        else:
            ranks = default_flora_ranks(fed.lora_rank, n_sample)
        return {"client_ranks": ranks[:n_sample]}
    return {}


def aggregate(method: str, global_lora, stacked, weights=None, **kw):
    try:
        fn = _AGGREGATORS[method]
    except KeyError:
        raise ValueError(
            f"unknown aggregation {method!r}; "
            f"available: {', '.join(available_aggregations())}") from None
    if weights is not None:
        # forwarded only when present, so aggregators registered without
        # the parameter keep working on unweighted runs
        kw["weights"] = weights
    return fn(global_lora, stacked, **kw)
