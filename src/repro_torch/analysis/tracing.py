"""Runtime sync guards (the transfer-guard half of the JAX package's
``repro.analysis.tracing``).

A synchronizing CUDA call — ``.item()``, ``.cpu()``, a host-to-device
copy from pageable memory, ``nonzero`` — makes the host wait for the
card. The serving step is designed to make one (reading its next
tokens) besides its host-to-device copies, and a step captured in a
CUDA graph may make none. ``guard_syncs`` runs a block under
``torch.cuda.set_sync_debug_mode``: ``"warn"`` counts (and warns about)
each synchronizing call, ``"error"`` raises on the first, ``"default"``
turns the guard off. Guards nest; each puts back the mode it found.

On a host without CUDA the guards are no-ops that count nothing, as the
JAX package's guard is on its CPU backend. The JAX package's
``CompileCounter`` has no counterpart: nothing in the port compiles.
"""
from __future__ import annotations

import contextlib
import dataclasses
import warnings
from typing import List

import torch

LEVELS = ("default", "warn", "error")

#: the text torch's sync-debug warning carries
_SYNC_TEXT = "called a synchronizing CUDA operation"


@dataclasses.dataclass
class SyncRecord:
    """What a ``guard_syncs`` block saw: the message of each
    synchronizing call made under ``"warn"``."""
    messages: List[str] = dataclasses.field(default_factory=list)

    @property
    def count(self) -> int:
        return len(self.messages)


@contextlib.contextmanager
def guard_syncs(level: str = "error"):
    """Run the block under ``torch.cuda.set_sync_debug_mode(level)`` and
    yield a :class:`SyncRecord` that holds, after the block, each
    synchronizing call it made (under ``"warn"``; a call inside a nested
    guard counts in the innermost one). Other warnings are issued again
    after the block."""
    if level not in LEVELS:
        raise ValueError(f"unknown sync debug level {level!r}; "
                         f"known: {list(LEVELS)}")
    record = SyncRecord()
    if not torch.cuda.is_available():
        yield record
        return
    previous = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(level)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield record
    finally:
        torch.cuda.set_sync_debug_mode(previous)
    for w in caught:
        if _SYNC_TEXT in str(w.message):
            record.messages.append(str(w.message))
        else:
            warnings.warn_explicit(w.message, w.category, w.filename,
                                   w.lineno)


@contextlib.contextmanager
def no_implicit_syncs():
    """Raise on the first synchronizing CUDA call in the block — e.g. a
    device scalar silently fetched by ``float()`` inside a hot loop.
    A no-op without CUDA."""
    with guard_syncs("error") as record:
        yield record
