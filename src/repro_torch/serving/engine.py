"""Continuous-batching multi-tenant serving engine.

One :class:`ServingEngine` owns a fixed pool of ``n_slots`` decode
slots, a ragged KV cache (``repro_torch.serving.kv_cache``) and — in
multi-tenant mode — an :class:`~repro_torch.serving.adapters.AdapterRegistry`
of batch-stacked LoRA adapters. Every engine step is ONE
``transformer.decode_step`` over all slots:

* slots in PREFILL feed their next prompt token (teacher-forced, the
  output is discarded) — a newly admitted request joins the running
  batch at once, while other slots keep decoding;
* slots in DECODE feed their last generated token;
* free slots ride along masked out (``active``): their lanes still
  compute and write their K/V, but their position cursor is frozen and
  their outputs ignored, so every step has the same shapes.

Per-slot adapters are gathered each step from the registry's
``(N, ...)``-stacked tree by the slot->adapter index vector and made
layer-major, ``(L, B, ...)``, so the layer loop hands each projection
batched ``(B, din, r)`` factors. Finished slots are recycled by zeroing
their cache lane in place (``KVCacheManager.reset_slot``).

Each step makes one host sync, to read the next tokens. ``warmup()``
runs one masked step before any request is timed; on the card that is
where the kernels are built and first launched.

Engine modes (mutually exclusive):

* ``adapters=AdapterRegistry`` — multi-tenant: every request names a
  registered adapter;
* ``lora=<tree>`` — one shared global adapter;
* neither — base / merged weights.
"""
from __future__ import annotations

import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.interop import tree_map
from repro_torch.models import transformer as T
from repro_torch.serving.adapters import AdapterRegistry
from repro_torch.serving.kv_cache import KVCacheManager, check_capacity
from repro_torch.serving.scheduler import Request, RequestState, SlotScheduler

OVERFLOW = ("error", "ring")


class ServingEngine:

    def __init__(self, cfg, params, *, lora=None,
                 adapters: Optional[AdapterRegistry] = None,
                 n_slots: int = 4, kv_capacity: int = 256,
                 policy: str = "fifo", overflow: str = "error",
                 stop_tokens: Sequence[int] = (),
                 clock: Callable[[], float] = time.perf_counter):
        if lora is not None and adapters is not None:
            raise ValueError("pass either a shared `lora` tree or an "
                             "`adapters` registry, not both")
        if overflow not in OVERFLOW:
            raise ValueError(f"unknown overflow policy {overflow!r}; "
                             f"known: {list(OVERFLOW)}")
        self.cfg = cfg
        self.params = params
        self.lora = lora
        self.adapters = adapters
        self.overflow = overflow
        self.device = params["embed"].device
        self.kv = KVCacheManager(cfg, n_slots, kv_capacity,
                                 device=self.device)
        self.scheduler = SlotScheduler(n_slots, policy=policy)
        self.finished: List[Request] = []
        self._stop = tuple(stop_tokens)
        self._clock = clock
        self._rid = 0
        self._adapter_idx = np.zeros((n_slots,), np.int64)
        self._warm = False

    # ---- one batched step ---------------------------------------------
    @torch.no_grad()
    def _step(self, idx: np.ndarray, tokens: np.ndarray,
              active: np.ndarray) -> torch.Tensor:
        """Run decode_step over every slot; keep the new cursor only on
        active slots. Returns the next token of every slot (on device)."""
        dev = self.device
        if self.adapters is not None:
            rows = torch.as_tensor(idx, device=dev)
            # (N, L, ...) -> per-slot rows (B, L, ...) -> layer-major (L, B, ...)
            lora = tree_map(lambda x: x[rows].movedim(0, 1),
                            self.adapters.stacked)
        else:
            lora = self.lora
        # host -> device copies before the step's launches (a copy from
        # pageable memory waits for the stream)
        tokens = torch.as_tensor(tokens, device=dev)
        active = torch.as_tensor(active, device=dev)
        cache = self.kv.cache
        logits, new = T.decode_step(self.cfg, self.params, lora, tokens, cache)
        new["pos"] = torch.where(active, new["pos"], cache["pos"])
        self.kv.cache = new
        return torch.argmax(logits[:, -1], dim=-1)

    # ---- request intake ----------------------------------------------
    def submit(self, prompt, *, max_new_tokens: int = 16,
               adapter: Optional[str] = None, priority: int = 0,
               stop_tokens: Optional[Sequence[int]] = None) -> Request:
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got "
                             f"{max_new_tokens}")
        check_capacity(self.kv.capacity, prompt.size, max_new_tokens,
                       self.overflow == "ring")
        if self.adapters is not None:
            if adapter is None:
                raise ValueError("multi-tenant engine: every request must "
                                 "name a registered adapter")
            self.adapters.index(adapter)          # existence check + touch
        elif adapter is not None:
            raise ValueError("engine has no adapter registry; submit "
                             "without `adapter` (shared/merged mode)")
        req = Request(rid=self._rid, prompt=prompt,
                      max_new_tokens=max_new_tokens, adapter=adapter,
                      priority=priority,
                      stop_tokens=tuple(stop_tokens)
                      if stop_tokens is not None else self._stop)
        self._rid += 1
        req.t_submit = self._clock()
        self.scheduler.submit(req)
        return req

    # ---- engine loop -------------------------------------------------
    def warmup(self) -> None:
        """Run one masked step before any request is timed (every slot
        inactive; its writes land in free lanes that admission resets).
        On the card this builds and first launches the kernels."""
        if self._warm:
            return
        if self.scheduler.n_active:
            raise RuntimeError("warmup() must run before admission")
        n = self.scheduler.n_slots
        nxt = self._step(np.zeros((n,), np.int64), np.zeros((n, 1), np.int64),
                         np.zeros((n,), bool))
        nxt.cpu()
        self._warm = True

    def _admit(self) -> None:
        now = self._clock()
        for slot, req in self.scheduler.admit():
            self.kv.reset_slot(slot)
            if self.adapters is not None:
                self._adapter_idx[slot] = self.adapters.index(req.adapter)
                self.adapters.pin(req.adapter)
            req.t_admit = now
            req.state = RequestState.PREFILL

    def _finish(self, slot: int, req: Request, now: float) -> None:
        req.state = RequestState.FINISHED
        req.t_finish = now
        if self.adapters is not None:
            self.adapters.unpin(req.adapter)
        self.scheduler.release(slot)
        self.finished.append(req)

    def step(self) -> List[Request]:
        """Admit what fits, run one batched decode step, harvest slot
        outputs. Returns the requests that finished this step."""
        self._admit()
        active = self.scheduler.active
        if not active:
            return []
        n = self.scheduler.n_slots
        tokens = np.zeros((n, 1), np.int64)
        mask = np.zeros((n,), bool)
        for slot, req in active:
            tokens[slot, 0] = req.next_feed()
            mask[slot] = True

        t0 = self._clock()
        nxt = self._step(self._adapter_idx, tokens, mask)
        nxt_host = nxt.cpu().numpy()               # the step's one host sync
        dt = self._clock() - t0
        now = t0 + dt

        done = []
        for slot, req in active:
            if req.cursor < req.prompt_len:        # consumed a prompt token
                req.cursor += 1
                req.prefill_s += dt
                if req.cursor < req.prompt_len:
                    continue                        # still prefilling
                # last prompt token -> this step produced the first output
                req.t_first_token = now
                req.state = RequestState.DECODE
            else:
                req.decode_times.append(dt)
            tok = int(nxt_host[slot])
            req.generated.append(tok)
            if (len(req.generated) >= req.max_new_tokens
                    or tok in req.stop_tokens):
                self._finish(slot, req, now)
                done.append(req)
        return done

    def has_work(self) -> bool:
        return self.scheduler.has_work()

    def run(self, prompts=None, *, max_new_tokens: int = 16,
            adapter=None, max_steps: Optional[int] = None) -> List[Request]:
        """Closed-loop convenience: optionally submit ``prompts`` (each a
        1-D token array; ``adapter`` a shared id or one id per prompt),
        then step until the queue drains. Returns the submitted requests
        (or everything finished during the drain)."""
        submitted = []
        if prompts is not None:
            ads = adapter if isinstance(adapter, (list, tuple)) \
                else [adapter] * len(prompts)
            for p, a in zip(prompts, ads):
                submitted.append(self.submit(
                    p, max_new_tokens=max_new_tokens, adapter=a))
        steps = 0
        while self.has_work():
            self.step()
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        return submitted or self.finished

