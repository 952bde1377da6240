"""Request lifecycle + slot scheduling for the serving engine.

A :class:`Request` carries one generation job through its lifecycle
(``QUEUED -> PREFILL -> DECODE -> FINISHED``) together with its timing
record (submit/admit/first-token/finish timestamps, per-phase wall
times). The :class:`SlotScheduler` owns a fixed pool of decode slots:
requests wait in a FIFO or priority queue and are admitted into free
slots mid-decode — admission never changes any tensor shape, so the
engine's step is the same across the whole workload.

Everything here is host-side bookkeeping (pure Python / numpy), copied
from the JAX package unchanged; the
device-facing state lives in ``repro_torch.serving.kv_cache`` and
``repro_torch.serving.adapters``.
"""
from __future__ import annotations

import dataclasses
import enum
import heapq
import itertools
from typing import List, Optional, Sequence, Tuple

import numpy as np

POLICIES = ("fifo", "priority")


class RequestState(enum.Enum):
    QUEUED = "queued"       # waiting for a free slot
    PREFILL = "prefill"     # prompt tokens streaming through the batch
    DECODE = "decode"       # generating
    FINISHED = "finished"   # stop condition hit; slot released


@dataclasses.dataclass
class Request:
    """One generation job and its measured lifecycle.

    ``prompt`` is a 1-D int32 token array; ``adapter`` names an entry in
    the engine's :class:`~repro_torch.serving.adapters.AdapterRegistry` (or is
    ``None`` for shared-adapter / merged-weights engines). ``stop_tokens``
    end generation early (the stop token is kept in ``generated``).
    Timestamps come from the engine clock; per-token latencies are
    engine-step wall times (one device program serves the whole batch,
    so a token's latency is the latency of the step that produced it).
    """

    rid: int
    prompt: np.ndarray
    max_new_tokens: int
    adapter: Optional[str] = None
    priority: int = 0
    stop_tokens: Tuple[int, ...] = ()
    # ---- lifecycle ---------------------------------------------------
    state: RequestState = RequestState.QUEUED
    slot: Optional[int] = None
    cursor: int = 0                       # prompt tokens consumed so far
    generated: List[int] = dataclasses.field(default_factory=list)
    # ---- timing (engine clock, seconds) ------------------------------
    t_submit: float = 0.0
    t_admit: Optional[float] = None
    t_first_token: Optional[float] = None
    t_finish: Optional[float] = None
    prefill_s: float = 0.0                # prompt-streaming wall time
    decode_times: List[float] = dataclasses.field(default_factory=list)

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def done(self) -> bool:
        return self.state is RequestState.FINISHED

    @property
    def ttft_s(self) -> Optional[float]:
        """Time to first token: submit -> first generated token (queueing
        + prefill, the latency a user perceives before output starts)."""
        if self.t_first_token is None:
            return None
        return self.t_first_token - self.t_submit

    @property
    def tokens(self) -> np.ndarray:
        return np.asarray(self.generated, dtype=np.int32)

    def next_feed(self) -> int:
        """The token this request feeds into the next engine step:
        prompt tokens while prefilling, then the last generated token."""
        if self.cursor < self.prompt_len:
            return int(self.prompt[self.cursor])
        return self.generated[-1]


class SlotScheduler:
    """Fixed pool of decode slots + an admission queue.

    ``policy``: ``"fifo"`` admits in submit order; ``"priority"`` admits
    lowest ``Request.priority`` first (ties broken by submit order).
    ``admit()`` assigns queued requests to free slots and is called by
    the engine before every step, which is what lets a prefilling
    request join a batch that is mid-decode.
    """

    def __init__(self, n_slots: int, policy: str = "fifo"):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        if policy not in POLICIES:
            raise ValueError(f"unknown policy {policy!r}; "
                             f"known: {list(POLICIES)}")
        self.n_slots = n_slots
        self.policy = policy
        self.slots: List[Optional[Request]] = [None] * n_slots
        self._heap: List[Tuple[int, int, Request]] = []
        self._order = itertools.count()

    # ---- queue -------------------------------------------------------
    def submit(self, req: Request) -> None:
        rank = req.priority if self.policy == "priority" else 0
        heapq.heappush(self._heap, (rank, next(self._order), req))

    @property
    def n_queued(self) -> int:
        return len(self._heap)

    # ---- slots -------------------------------------------------------
    @property
    def n_active(self) -> int:
        return sum(r is not None for r in self.slots)

    @property
    def active(self) -> Sequence[Tuple[int, Request]]:
        return [(i, r) for i, r in enumerate(self.slots) if r is not None]

    def admit(self) -> List[Tuple[int, Request]]:
        """Assign queued requests to free slots; returns the admissions
        as ``(slot, request)`` (the engine resets the slot's device
        state and pins the request's adapter)."""
        out = []
        for slot, occupant in enumerate(self.slots):
            if occupant is not None or not self._heap:
                continue
            _, _, req = heapq.heappop(self._heap)
            req.slot = slot
            self.slots[slot] = req
            out.append((slot, req))
        return out

    def release(self, slot: int) -> None:
        self.slots[slot] = None

    def has_work(self) -> bool:
        return bool(self._heap) or self.n_active > 0
