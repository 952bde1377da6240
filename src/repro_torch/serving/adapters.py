"""Batch-stacked LoRA adapter registry: N adapters resident on the
device, selectable per decode slot by index.

The registry stores adapters as ONE stacked tree — each leaf carries a
leading ``(N, ...)`` residency axis over the canonical per-adapter tree
``{stack: {target: {'a': (L, d, r), 'b': (L, r, out)}}}``. The engine
gathers per-slot rows each step (``leaf[idx]`` with ``idx`` the ``(B,)``
slot->adapter index vector), so any resident subset of adapters is
served without weight swapping; shapes depend only on the residency
capacity ``N``.

On MLA (deepseek-v3) the targets are ``wq_b`` and ``wkv_b``; decoding
merges each slot's ``wkv_b`` adapter into a per-slot up-projection
(``layers.mla_decode``), as the JAX package does. On whisper-tiny the
adapters cover the decoder (``dec``) only: the encoder stays frozen.

Populations larger than residency are handled by LRU admission and
eviction: ``add`` overwrites the least-recently-used unpinned row;
adapters in use by active requests are pinned, so an eviction never
swaps an adapter out from under a running decode.

``registry_from_run`` closes the train->serve loop: it exports a finished
``run_experiment`` run's adapters — the aggregated global adapter plus
per-client personalized variants (a few local fine-tuning steps on each
client's own data, starting from the global adapter) — straight into a
registry the engine can serve from.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional

import torch

from repro_torch.interop import tree_map, tree_paths


def _signature(tree):
    """Structure and leaf shapes of a tree (what every adapter of one
    registry must share)."""
    return [(path, tuple(leaf.shape)) for path, leaf in tree_paths(tree)]


class AdapterRegistry:
    """Device-resident pool of ``capacity`` batch-stacked LoRA adapters.

    ``template`` is any single-adapter tree (e.g. from
    ``transformer.init_lora``); it fixes the structure, leaf shapes,
    dtypes and device of every row. Rows start as zero adapters
    (``b = 0`` -> identity), so an index pointing at an unoccupied row
    serves the base model.
    """

    def __init__(self, template, capacity: int):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._sig = _signature(template)
        self._stack = tree_map(
            lambda l: torch.zeros((capacity,) + tuple(l.shape),
                                  dtype=l.dtype, device=l.device), template)
        self._slots: "OrderedDict[str, int]" = OrderedDict()  # id -> row
        self._free: List[int] = list(range(capacity))
        self._pinned: Dict[str, int] = {}                     # id -> pin count
        self.evictions = 0

    @classmethod
    def for_model(cls, cfg, rank: int, capacity: int,
                  device="cuda") -> "AdapterRegistry":
        """Empty registry shaped for ``cfg``'s LoRA targets at ``rank``."""
        from repro_torch.models import transformer as T
        gen = torch.Generator(device=device).manual_seed(0)
        template = T.init_lora(cfg, gen, rank=rank)
        return cls(template, capacity)

    # ---- introspection ----------------------------------------------
    def __len__(self) -> int:
        return len(self._slots)

    def __contains__(self, adapter_id: str) -> bool:
        return adapter_id in self._slots

    def ids(self) -> List[str]:
        """Registered ids, least-recently-used first."""
        return list(self._slots)

    @property
    def stacked(self):
        """The ``(N, ...)``-stacked tree the engine gathers from."""
        return self._stack

    # ---- admission / lookup -----------------------------------------
    def _validate(self, lora) -> None:
        if _signature(lora) != self._sig:
            raise ValueError(
                "adapter tree does not match the registry template "
                "(structure or leaf shapes differ)")

    def add(self, adapter_id: str, lora) -> int:
        """Register (or overwrite) ``adapter_id``; returns its row.
        Evicts the least-recently-used unpinned adapter when full."""
        self._validate(lora)
        if adapter_id in self._slots:
            row = self._slots[adapter_id]
        elif self._free:
            row = self._free.pop(0)
        else:
            victim = next((v for v in self._slots if v not in self._pinned),
                          None)
            if victim is None:
                raise RuntimeError(
                    f"registry full ({self.capacity}) and every resident "
                    f"adapter is pinned by an active request")
            row = self._slots.pop(victim)
            self.evictions += 1
        tree_map(lambda s, l: s[row].copy_(l), self._stack, lora)
        self._slots[adapter_id] = row
        self._slots.move_to_end(adapter_id)
        return row

    def index(self, adapter_id: str) -> int:
        """Row of ``adapter_id`` (marks it most-recently-used)."""
        if adapter_id not in self._slots:
            raise KeyError(f"adapter {adapter_id!r} is not resident; "
                           f"registered: {self.ids()}")
        self._slots.move_to_end(adapter_id)
        return self._slots[adapter_id]

    def get(self, adapter_id: str):
        """Copy of one adapter tree (tests / checkpoint export)."""
        row = self.index(adapter_id)
        return tree_map(lambda s: s[row].clone(), self._stack)

    # ---- pinning (active-request protection) ------------------------
    def pin(self, adapter_id: str) -> None:
        self.index(adapter_id)                    # touch + existence check
        self._pinned[adapter_id] = self._pinned.get(adapter_id, 0) + 1

    def unpin(self, adapter_id: str) -> None:
        n = self._pinned.get(adapter_id, 0) - 1
        if n <= 0:
            self._pinned.pop(adapter_id, None)
        else:
            self._pinned[adapter_id] = n


def personalized_adapters(result, params, data=None, *,
                          k_steps: Optional[int] = None):
    """Per-client personalized adapters for a finished run: from the
    aggregated global adapter, run ``k_steps`` (default: the run's
    ``k_local``) of plain local training on each client's OWN data.
    Returns ``{client_id: lora_tree}``.

    ``params`` is the base-model tree the run fine-tuned (the runner's
    pretrained base); training runs on its device. ``data`` defaults to
    the run's federated dataset, rebuilt deterministically from the
    spec.
    """
    from repro_torch.data.synthetic import (client_round_batches,
                                            make_federated_data)
    from repro_torch.federated.client import make_local_train

    spec = result.spec
    if result.final_lora is None:
        raise ValueError("result carries no final_lora (loaded from JSON? "
                         "adapters are in-memory only)")
    cfg = spec.build_cfg()
    if data is None:
        data = make_federated_data(cfg.vocab, n_clients=spec.n_clients,
                                   alpha=spec.alpha, noise=spec.noise,
                                   seed=spec.seed)
    k = k_steps or spec.k_local
    local = make_local_train(cfg)
    out = {}
    for c in range(spec.n_clients):
        batches = client_round_batches(
            data, [c], k, spec.local_batch, spec.seq,
            # fresh stream, disjoint from every training round's
            seed=(spec.seed, spec.rounds + 1 + c))
        one = {key: v[0] for key, v in batches.items()}
        lora_c, _ = local(params, result.final_lora, one, spec.lr)
        out[c] = lora_c
    return out


def registry_from_run(result, params, data=None, *,
                      personalize: bool = True,
                      k_steps: Optional[int] = None,
                      capacity: Optional[int] = None) -> AdapterRegistry:
    """Export a finished run into a serving registry: the global
    aggregated adapter under ``"global"`` and (``personalize=True``)
    one personalized adapter per client under ``"client/<i>"``.
    """
    spec = result.spec
    if result.final_lora is None:
        raise ValueError("result carries no final_lora (loaded from JSON? "
                         "adapters are in-memory only)")
    capacity = capacity or (spec.n_clients + 1 if personalize else 1)
    reg = AdapterRegistry(result.final_lora, capacity)
    reg.add("global", result.final_lora)
    if personalize:
        for c, lora_c in personalized_adapters(
                result, params, data, k_steps=k_steps).items():
            reg.add(f"client/{c}", lora_c)
    return reg
