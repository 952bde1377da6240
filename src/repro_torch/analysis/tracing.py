"""Runtime tracing: spans and counters for the profiler, and sync guards
(the transfer-guard half of the JAX package's ``repro.analysis.tracing``).

Spans. :func:`span` marks a range of the program with
``torch.profiler.record_function("repro_torch/<name>")`` while a profiler
is running, and is one shared no-op context otherwise: the gate is
``torch.autograd._profiler_enabled()`` (a fraction of a microsecond),
so no flag or environment variable turns spans on and an unprofiled run
pays only the gate. A span lands in the profiler's trace, on its clock,
beside the device operations and CUDA runtime calls launched inside it.
The sites, each under ``repro_torch/``:

* the round engine (``federated/simulator.py``): ``round.batches``,
  ``round.to_device``, ``round.local`` (the client loop), ``client.train``
  (one client), ``round.aggregate``, ``round.post_round``, ``round.eval``
  and ``round.books`` (the ``RoundLog`` accounting); the ``progress``
  callback runs outside every span;
* the stage entry (``federated/methods/devft.py``, ``core/devft.py``):
  ``devft.stage_entry`` around the strategy's ``on_stage``, with
  ``devft.transfer``, ``devft.grouping`` and ``devft.fusion`` inside;
* the local step (``federated/client.py``, ``models/transformer.py``):
  ``client.step``, with ``step.forward``, ``step.backward`` (the
  ``autograd.grad`` call) and ``step.adamw``;
* the MoE block (``models/moe.py``): ``moe.route``, ``moe.dispatch``,
  ``moe.experts`` and ``moe.combine``;
* MLA's training attention (``models/layers.py`` ``mla_attention``):
  ``mla.latent`` (the down-projections, their norms and the rotations),
  ``mla.expand`` (the up-projections and the shared rotary key's
  concat) and ``mla.attend`` (the attention, with v's pad and the
  output's slice where the flash kernel takes it);
* the training kernels (``kernels/ops.py``): ``kernel.<name>`` around the
  forward's kernel call and ``kernel.<name>.backward`` around the
  backward, for ``lora_matmul``, ``flash_attention``, ``moe_expert_ffn``
  and ``ssd_scan``.

Counters. :func:`counters` gathers the kernel wrappers' own call counts
(``<kernel>.launches``, ``.variants``, ``.padded`` and ``.filled`` where
the wrapper keeps them, and ``lora_matmul_bwd.plain``, the backward calls
on the card that did not take the input-gradient kernel; ``reset_counts``
of each kernel module zeroes them) and the MoE slot counts
``moe.routed_slots``, ``moe.dropped_slots`` and ``moe.held_slots`` (the
routed slots whose expert the layer holds: all of them but in an expert
share or on an expert-parallel rank): device int64
accumulators that ``moe_block`` and ``moe_block_ep`` bump
(:func:`count_moe`) only while spans are on, read with one
device-to-host copy by :func:`counters`. With spans off they
allocate and launch nothing. :func:`reset_counters` zeroes both kinds.

Sync guards. A synchronizing CUDA call — ``.item()``, ``.cpu()``, a
host-to-device copy from pageable memory, ``nonzero`` — makes the host
wait for the card. The serving step is designed to make one (reading its
next tokens) besides its host-to-device copies, and a step captured in a
CUDA graph may make none. ``guard_syncs`` runs a block under
``torch.cuda.set_sync_debug_mode``: ``"warn"`` counts (and warns about)
each synchronizing call, ``"error"`` raises on the first, ``"default"``
turns the guard off. Guards nest; each puts back the mode it found. On a
host without CUDA the guards are no-ops that count nothing, as the JAX
package's guard is on its CPU backend. The JAX package's
``CompileCounter`` has no counterpart: nothing in the port compiles.

This module imports nothing of the port beyond the analysis package's
core, so the model, kernel and federated modules import it freely.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import warnings
from typing import Dict, List, Optional

import torch

LEVELS = ("default", "warn", "error")

#: the prefix of every span's name in the profiler's trace
PREFIX = "repro_torch/"

#: the text torch's sync-debug warning carries
_SYNC_TEXT = "called a synchronizing CUDA operation"

#: what :func:`span` returns while no profiler runs
_OFF = contextlib.nullcontext()

#: registry name -> (kernel module, its counted wrapper)
_KERNEL_WRAPPERS = {
    "lora_matmul": ("lora_matmul", "lora_matmul_fused"),
    "lora_matmul_bwd": ("lora_matmul", "lora_matmul_bwd"),
    "flash_attention": ("flash_attention", "flash_attention_bshd"),
    "moe_expert_ffn": ("moe_ffn", "moe_expert_ffn_ecd"),
    "ssd_scan": ("ssd_scan", "ssd_scan_bshp"),
    "flash_decode": ("flash_decode", "flash_decode_bhrd"),
}
_KERNEL_COUNTS = ("launches", "variants", "padded", "filled", "plain")

#: device -> (2,) int64: MoE slots routed, and dropped past capacity
_MOE: Dict[torch.device, torch.Tensor] = {}


def span(name: str):
    """A ``repro_torch/<name>`` range in the profiler's trace while a
    profiler runs, else the shared no-op context."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(PREFIX + name)
    return _OFF


def count_moe(keep: torch.Tensor, routed: Optional[torch.Tensor] = None,
              held: Optional[torch.Tensor] = None) -> None:
    """Add one MoE dispatch to ``moe.routed_slots``,
    ``moe.dropped_slots`` and ``moe.held_slots`` while spans are on.
    ``keep``: (S,) bool, the slots that got a row; ``routed``: (S,) bool,
    the slots this block routes (every slot where None); ``held``: (S,)
    bool, the routed slots whose expert this block holds (every routed
    slot where None). A routed slot held here that got no row dropped.
    No host sync."""
    if not torch.autograd._profiler_enabled() or keep.is_meta:
        return
    acc = _MOE.get(keep.device)
    if acc is None:
        acc = _MOE[keep.device] = torch.zeros(3, dtype=torch.int64,
                                              device=keep.device)
    if routed is None:
        acc[0].add_(keep.numel())
        routed = torch.ones_like(keep)
    else:
        acc[0].add_(routed.sum())
    held = routed if held is None else held
    acc[1].add_((held & ~keep).sum())
    acc[2].add_(held.sum())


def _kernel_wrappers():
    for name, (module, fn) in _KERNEL_WRAPPERS.items():
        mod = importlib.import_module(f"repro_torch.kernels.{module}")
        yield name, mod, getattr(mod, fn)


def counters() -> Dict[str, object]:
    """The kernel wrappers' counts (``<kernel>.launches`` and the rest,
    read from the wrappers, not copied) and the MoE slot counts since the
    last :func:`reset_counters`."""
    out: Dict[str, object] = {}
    for name, _, fn in _kernel_wrappers():
        for key in _KERNEL_COUNTS:
            if hasattr(fn, key):
                val = getattr(fn, key)
                out[f"{name}.{key}"] = dict(val) if key == "variants" \
                    else val
    routed = dropped = held = 0
    if _MOE:
        routed, dropped, held = (int(v) for v in
                                 sum(acc.cpu() for acc in _MOE.values()))
    out["moe.routed_slots"], out["moe.dropped_slots"] = routed, dropped
    out["moe.held_slots"] = held
    return out


def reset_counters() -> None:
    """Zero the kernel wrappers' counts and the MoE slot counts."""
    for _, mod, _ in _kernel_wrappers():
        mod.reset_counts()
    _MOE.clear()


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
