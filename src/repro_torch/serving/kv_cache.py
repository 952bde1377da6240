"""Ragged KV-cache manager: per-slot write cursors over the model's
stacked cache tree, with reset-on-recycle. The tree holds each layer's
K/V rows (attention), latent ``c`` and shared rotary key ``k_rope``
(MLA), conv window and f32 SSM state (Mamba-2), and whisper's decoder
cross-attention K/V (``cross_k``/``cross_v``, which nothing in serving
writes, as in the JAX package); every leaf is ``(L, B, ...)``, so a
slot is one lane of each, and ``reset_slot`` zeros all of them.

The decode cache (``transformer.init_cache``) carries a per-slot
position vector ``pos (B,)``; the decode path writes each slot's new K/V
at its own cursor (``pos % capacity`` per batch row) and masks reads
with ``kv_valid_len = min(pos + 1, capacity)``. This manager owns that
tree for a slot pool: allocation at a fixed ``(n_slots, capacity)``,
per-slot validity windows, and an in-place zero reset of one slot when
it is recycled to a new request.

Kernel seam: single-token decode attention goes through the
``flash_decode`` name of ``repro_torch.kernels.dispatch``; the public
helper ``flash_decode(q, k, v, *, kv_valid_len, scale=None,
backend="reference")`` below keeps the JAX package's signature, with
``q (B, 1, H, hd)``, cache-resident ``k/v (B, C, Hkv, hd)`` and
``kv_valid_len (B,)``. ``backend="auto"`` (or ``"pallas"``) on a CUDA
tensor is the Hopper kernel.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.interop import tree_leaves
from repro_torch.kernels import dispatch
from repro_torch.models import transformer as T


class KVCacheManager:
    """Fixed-pool ragged cache for ``n_slots`` decode slots of capacity
    ``capacity`` tokens each, on ``device``. ``cache`` is the live tree
    the engine passes to each step (it keeps the returned ``pos``);
    ``reset_slot`` recycles one slot without touching the rest."""

    def __init__(self, cfg, n_slots: int, capacity: int, dtype=None,
                 device="cuda"):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.cfg = cfg
        self.n_slots = n_slots
        self.capacity = capacity
        self.cache = T.init_cache(cfg, n_slots, capacity,
                                  dtype or getattr(torch, cfg.dtype), device)

    def reset_slot(self, slot: int) -> None:
        """Zero one slot's lane in every layer (stack leaves are
        ``(L, B, ...)``: batch axis 1) and its cursor, in place."""
        for leaf in tree_leaves(self.cache["stacks"]):
            leaf[:, slot].zero_()
        self.cache["pos"][slot] = 0

    # ---- host-side views --------------------------------------------
    def positions(self) -> np.ndarray:
        """Per-slot write cursors (absolute token positions)."""
        return self.cache["pos"].cpu().numpy()

    def valid_len(self) -> np.ndarray:
        """Per-slot count of live cache entries (ragged lengths)."""
        return np.minimum(self.positions(), self.capacity)

    def fits(self, n_tokens: int) -> bool:
        """Whether a request of ``n_tokens`` total (prompt + generated)
        fits without ring-buffer wraparound."""
        return n_tokens <= self.capacity


def check_capacity(capacity: int, prompt_len: int, max_new: int,
                   ring: bool, *, what: str = "request") -> None:
    """Shared admission guard: a job needing ``prompt_len + max_new``
    cache entries either fits, runs as an explicit ring buffer
    (sliding-window attention over the last ``capacity`` tokens via
    ``kv_valid_len``), or is an error — never a silent truncation."""
    need = prompt_len + max_new
    if need > capacity and not ring:
        raise ValueError(
            f"{what} needs {need} cache entries (prompt {prompt_len} + "
            f"gen {max_new}) but capacity is {capacity}; raise the "
            f"capacity or opt into ring-buffer (sliding-window) decode "
            f"explicitly")


def flash_decode(q, k, v, *, kv_valid_len, scale: Optional[float] = None,
                 backend: str = "reference"):
    """Single-token ragged-cache attention through the dispatch seam:
    ``reference`` is the plain version on any device; ``auto`` and
    ``pallas`` resolve by ``q``'s device (the Hopper kernel on the card,
    raising where there is none; the plain version on the CPU)."""
    fd = dispatch.get_kernel("flash_decode", backend, q.device)
    return fd(q, k, v, kv_valid_len=kv_valid_len, scale=scale)
