"""Federated fine-tuning jobs through the program's user entry,
``repro_torch.experiments.runner.run_experiment``.

Set-up builds the kernels, makes the base weights and the initial LoRA on
the device, the corpus on the host, and runs one job at the warm-up's K,
which runs every stage's shapes. The window runs whole jobs back to back,
each from the set-up's weights and a fresh copy of the initial LoRA; the
``round_progress`` callback marks the round boundaries, so the rounds
tile the window and each job's set-up, stage entries, batch preparation,
aggregation and eval fall in some round. The window ends at the first
round boundary after ``seconds`` by which every stage of the job's cycle
has had a round.

The first job of the window is recorded for the check (``Capture``):
each round's cohort, the followed steps of the client the seed picks
(``fedbench.data.followed``: their losses, the LoRA and AdamW state
before them and the state after the first, the LoRA after the last),
every client's result and the aggregate, and each stage's entry and
exit. The wrappers keep references to the program's small LoRA trees and
read nothing from the device; they are undone when the job ends.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import time
import typing
from types import ModuleType
from typing import Any, Dict, List, Optional

import torch

from fedbench import data as D
from fedbench import weights as W
from fedbench.reference import devft as RD


class WindowClosed(Exception):
    """Raised from the round callback to end a job when the window ends."""


@contextlib.contextmanager
def patched(*items):
    """Set (owner, attribute, value) for the block, then restore."""
    old = [(o, a, getattr(o, a)) for o, a, _ in items]
    try:
        for o, a, v in items:
            setattr(o, a, v)
        yield
    finally:
        for o, a, v in reversed(old):
            setattr(o, a, v)


def model_config(model: dict):
    """The port's ``ModelConfig`` from a configuration file's ``model``
    section; nested groups go to the dataclass their field names."""
    from repro_torch.configs.base import ModelConfig

    hints = typing.get_type_hints(ModelConfig)
    kw = {}
    for key, val in model.items():
        if isinstance(val, dict):
            cls = [t for t in typing.get_args(hints[key])
                   if dataclasses.is_dataclass(t)][0]
            val = cls(**val)
        kw[key] = val
    return ModelConfig(**kw)


def _cell_spec():
    from repro_torch.experiments.spec import ExperimentSpec

    @dataclasses.dataclass(frozen=True)
    class CellSpec(ExperimentSpec):
        """The spec with the configuration file's model in place of the
        registry's."""
        model: Any = None

        def build_cfg(self):
            return dataclasses.replace(self.model,
                                       kernel_backend=self.kernel_backend)
    return CellSpec


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


class Cell:
    """Everything a run of one cell builds in set-up; ``reference`` is the
    configuration's reference module (``Bench.reference``)."""

    def __init__(self, cfg_doc: dict, reference: ModuleType, traffic: dict,
                 seed: int, device: str, phases: Dict[str, float]):
        from repro_torch.data.synthetic import FederatedData
        from repro_torch.kernels import build

        self.doc, self.traffic, self.seed, self.device = (cfg_doc, traffic,
                                                          seed, device)
        self.reference = reference
        self.model = cfg_doc["model"]
        self.dtype = getattr(torch, self.model["dtype"])
        t = time.perf_counter()
        if device == "cuda":
            build.build_all()
        phases["kernels_s"] = time.perf_counter() - t
        t = time.perf_counter()
        self.cfg = model_config(self.model)
        if device == "cuda":
            torch.empty(1, device=device)
            phases["cuda_init_s"] = time.perf_counter() - t
        self.params, self.lora0 = W.make(self.cfg, cfg_doc, seed, device,
                                         phases)
        _sync(device)
        phases["weights_s"] = time.perf_counter() - t
        t = time.perf_counter()
        sp = traffic["spec"]
        self.corpus = D.make_corpus(self.model["vocab"], sp["n_clients"],
                                    sp["alpha"], sp["noise"], seed)
        self.data = FederatedData(
            vocab=self.corpus["vocab"], n_clients=self.corpus["n_clients"],
            global_perm=self.corpus["global_perm"],
            client_perms=self.corpus["client_perms"], mix=self.corpus["mix"],
            noise=self.corpus["noise"])
        self.spec = _cell_spec()(
            model=self.cfg, full=True, seed=seed, pretrain_steps=0,
            lora_rank=cfg_doc["lora"]["rank"],
            **{k: v for k, v in sp.items() if k not in ("alpha", "noise")})
        phases["data_s"] = time.perf_counter() - t
        self.n_sample = max(1, int(sp["n_clients"] * sp["sample_frac"]))
        self.plan = _plan(self.model, sp)
        self.sizes = {n: len(RD._sorted_leaves(s)[0])
                      for n, s in self.params["blocks"].items()}

    def job(self, round_progress=None, **overrides):
        from repro_torch.experiments.runner import run_experiment

        spec = self.spec.replace(**overrides) if overrides else self.spec
        return run_experiment(spec, data=self.data, params=self.params,
                              lora=_clone(self.lora0), device=self.device,
                              dtype=self.dtype, round_progress=round_progress)

    def stack_sizes(self, capacity: int) -> Dict[str, int]:
        if self.traffic["spec"]["method"] == "devft":
            return RD.stack_capacities(self.sizes, capacity)
        return dict(self.sizes)


def _plan(model, sp):
    from fedbench.reference.fed import stage_plan
    return stage_plan(model, sp)


def _sync(device):
    if device == "cuda":
        torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# the check's records of a job
# ---------------------------------------------------------------------------

class Capture:
    """Records the job of ``cell`` for the check (see the module
    docstring). ``fault`` plants a fault in the program, for the faults
    the check must catch: ``half_batch`` (the loss and its gradient over
    the first half of each batch's rows), ``frozen`` (the optimizer step
    returns the LoRA and its state unchanged) or ``half_clients`` (the
    aggregate over the first half of the round's clients). ``where``
    narrows the fault to the local steps ``(client, step)`` it accepts."""

    def __init__(self, cell: Cell, fault: Optional[str] = None,
                 where=None):
        sp = cell.traffic["spec"]
        self.steps = cell.traffic["check_steps"]
        self.follows = D.followed(cell.seed, len(cell.plan), cell.n_sample,
                                  sp["k_local"], self.steps)
        self.fault, self.where = fault, where
        self.rec = {"program": True, "rounds": [], "entries": {},
                    "final": None}
        self._client = -1
        self._step = 0

    def _round(self):
        return self.rec["rounds"][-1]

    def _faulty(self, kind: str) -> bool:
        return self.fault == kind and (
            self.where is None or self.where(self._client, self._step))

    def _followed(self):
        """The followed step's place in the window (0 first), else None."""
        client, first = self.follows[len(self.rec["rounds"]) - 1]
        k = self._step - first
        return k if client == self._client and 0 <= k < self.steps else None

    @contextlib.contextmanager
    def installed(self):
        from repro_torch.federated import client, simulator

        cap = self
        make_strategy = simulator.make_strategy
        make_local = simulator.make_local_train
        host_batches = simulator.FederatedRunner._host_batches
        grads_fn, adamw_fn = client.loss_and_lora_grads, client.adamw_update

        def strategy(*a, **kw):
            strat = make_strategy(*a, **kw)
            on_stage, aggregate = strat.on_stage, strat.aggregate
            finalize = strat.finalize

            def w_on_stage(state, stage):
                sub = state.get("sub")
                trained = None if sub is None else sub.lora
                on_stage(state, stage)
                sub = state.get("sub")
                cap._round()["entry_stage"] = stage
                cap.rec["entries"][stage] = {
                    "global": state["lora"], "trained_prev": trained,
                    "groups": None if sub is None else
                    {n: p["groups"] for n, p in sub.plan.items()},
                    "sub_lora": None if sub is None else sub.lora}

            def w_aggregate(state, spec, stacked, n, weights=None):
                part = stacked
                if cap._faulty("half_clients"):
                    k = max(1, n // 2)
                    part = {s: _index(t, slice(0, k))
                            for s, t in stacked.items()}
                new, up = aggregate(state, spec, part, n, weights=weights)
                rnd = cap._round()
                rnd["agg"] = new
                n_c = next(iter(_leaves(stacked))).shape[0]
                rnd["finals"] = [_index(stacked, c) for c in range(n_c)]
                return new, up

            def w_finalize(state):
                sub = state.get("sub")
                trained = None if sub is None else sub.lora
                out = finalize(state)
                cap.rec["final"] = {"trained": trained, "global": out}
                return out
            strat.on_stage, strat.aggregate = w_on_stage, w_aggregate
            strat.finalize = w_finalize
            return strat

        def w_host_batches(runner, rnd):
            clients, batches = host_batches(runner, rnd)
            cap.rec["rounds"].append({"clients": [int(c) for c in clients]})
            return clients, batches

        def local_train(sub_cfg, **kw):
            local = make_local(sub_cfg, **kw)
            cap._client = -1

            def run(*a, **kw2):
                cap._client += 1
                cap._step = 0
                return local(*a, **kw2)
            return run

        def w_grads(cfg, params, lora, batch, **kw):
            if cap._faulty("half_batch"):
                half = batch["labels"].shape[0] // 2
                batch = {k: v[:half] for k, v in batch.items()}
            total, metrics, g = grads_fn(cfg, params, lora, batch, **kw)
            if cap._followed() is not None:
                cap._round().setdefault("loss_t", []).append(metrics["loss"])
            return total, metrics, g

        def w_adamw(grads, state, lora, lr, **kw):
            if cap._faulty("frozen"):
                new, st = lora, state
            else:
                new, st = adamw_fn(grads, state, lora, lr, **kw)
            k = cap._followed()
            if k is not None:
                rnd = cap._round()
                if k == 0:
                    rnd["start"], rnd["state"], rnd["mu1"] = lora, state, st.mu
                if k == cap.steps - 1:
                    rnd["after"] = new
            cap._step += 1
            return new, st

        with patched((simulator, "make_strategy", strategy),
                     (simulator, "make_local_train", local_train),
                     (simulator.FederatedRunner, "_host_batches",
                      w_host_batches),
                     (client, "loss_and_lora_grads", w_grads),
                     (client, "adamw_update", w_adamw)):
            yield self

    def on_round(self, log):
        self._round()["eval"] = float(log.eval_loss)

    def records(self) -> dict:
        """The records in the check's form (``fedbench.check``)."""
        from fedbench.check import B1

        rounds = []
        for rnd in self.rec["rounds"]:
            entry = self.rec["entries"].get(rnd.get("entry_stage"))
            st = rnd["state"]
            rounds.append({
                "clients": rnd["clients"],
                "losses": [float(x) for x in rnd["loss_t"]],
                "g1": _lin(rnd["mu1"], st.mu, 1.0 / (1.0 - B1),
                           -B1 / (1.0 - B1)),
                "state": {"count": int(st.count), "mu": st.mu,
                          "nu": st.nu},
                "start": rnd["start"], "after": rnd["after"],
                "finals": rnd["finals"], "agg": rnd["agg"],
                "eval": rnd["eval"],
                "entry": entry and entry["sub_lora"],
                "groups": entry and entry["groups"]})
        return {"program": True, "rounds": rounds,
                "entries": self.rec["entries"], "final": self.rec["final"]}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _index(tree, i):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _lin(a, b, fa, fb):
    """fa a + fb b, leaf by leaf, in f64 (the program's f32 moments)."""
    if isinstance(a, dict):
        return {k: _lin(a[k], b[k], fa, fb) for k in a}
    return fa * a.double() + fb * b.double()


# ---------------------------------------------------------------------------
# the window
# ---------------------------------------------------------------------------

class Window:
    """Round boundaries of the jobs run back to back."""

    def __init__(self, cell: Cell, seconds: float):
        self.cell, self.seconds = cell, seconds
        self.rounds: List[dict] = []      # {"stage", "capacity", "s"}
        self.jobs = 0
        self.stages = {s for s, _ in cell.plan}

    def run(self, capture: Optional[Capture] = None):
        cell = self.cell
        _sync(cell.device)
        if cell.device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        self.t0 = last = time.perf_counter()
        done = False
        while not done:
            in_job = 0

            def boundary(log):
                nonlocal last, done, in_job
                _sync(cell.device)
                now = time.perf_counter()
                self.rounds.append({"stage": log.stage,
                                    "capacity": log.capacity,
                                    "s": now - last,
                                    "eval": float(log.eval_loss)})
                last = now
                in_job += 1
                if capture is not None and self.jobs == 0:
                    capture.on_round(log)
                seen = {x["stage"] for x in self.rounds}
                if now - self.t0 >= self.seconds and seen >= self.stages:
                    done = True
                    if in_job < len(cell.plan):
                        raise WindowClosed
            cm = capture.installed() if capture is not None \
                and self.jobs == 0 else contextlib.nullcontext()
            try:
                with cm:
                    cell.job(round_progress=boundary)
            except WindowClosed:
                pass
            self.jobs += 1
        _sync(cell.device)
        self.t1 = time.perf_counter()
        self.peak_bytes = torch.cuda.max_memory_allocated() \
            if cell.device == "cuda" else 0

    def rate(self) -> float:
        """Client tokens of one cycle over the cycle's stage-weighted time:
        each stage's mean round time in the window times its rounds in a
        cycle."""
        sp = self.cell.traffic["spec"]
        per_round = (self.cell.n_sample * sp["k_local"] * sp["local_batch"]
                     * sp["seq"])
        return stage_weighted_rate(self.rounds, self.cell.plan, per_round)

    def flops(self) -> float:
        from fedbench.flops import round_flops

        cell = self.cell
        return sum(round_flops(cell.reference, cell.model,
                               cell.stack_sizes(r["capacity"]),
                               cell.traffic["spec"], cell.n_sample,
                               cell.traffic["eval_batch"],
                               cell.doc["lora"]["rank"])
                   for r in self.rounds)

    def seconds_measured(self) -> float:
        return sum(r["s"] for r in self.rounds)


def stage_weighted_rate(rounds: List[dict], plan: List[tuple],
                        tokens_per_round: float) -> float:
    """tokens of one cycle / sum over stages of (rounds of the stage in a
    cycle) x (the stage's mean round time in the window)."""
    per_stage: Dict[int, List[float]] = {}
    for r in rounds:
        per_stage.setdefault(r["stage"], []).append(r["s"])
    r_s: Dict[int, int] = {}
    for stage, _ in plan:
        r_s[stage] = r_s.get(stage, 0) + 1
    if set(r_s) - set(per_stage):
        return float("nan")
    t = sum(n * sum(per_stage[s]) / len(per_stage[s]) for s, n in r_s.items())
    return len(plan) * tokens_per_round / t


# ---------------------------------------------------------------------------
# the traced cycle
# ---------------------------------------------------------------------------

class Traced:
    """One more job under ``torch.profiler``, with the harness spans and
    the registry kernels labelled and their calls recorded. Its readings:
    ``summary``, the harness's (``fedbench.trace.summarize``); ``trace``
    and ``program``, the program's own spans (``fedbench.program_trace``:
    the ``Trace`` and its summary); ``counters``, the program's counters
    over the cycle (``repro_torch.analysis.tracing.counters``); and
    ``read_s``, the seconds spent reading them."""

    def __init__(self, cell: Cell, kernel_files: Dict[str, Any]):
        self.cell, self.kernel_files = cell, kernel_files
        self.calls: Dict[str, list] = {k: [] for k in kernel_files}
        self.stage_entry_s: List[float] = []
        self.summary: Dict = {}
        self.trace = None
        self.program: Dict = {}
        self.counters: Dict = {}
        self.read_s = 0.0

    def _kernel_patches(self):
        from repro_torch.kernels import dispatch

        dispatch.available_kernels()
        items = []
        for name, mod in self.kernel_files.items():
            impls = dispatch._KERNELS.get(name, {})
            fn = impls.get("pallas")
            if fn is None:
                continue

            def wrapped(*a, _fn=fn, _name=name, _mod=mod, **kw):
                self.calls[_name].append(_mod.record(a, kw))
                with torch.profiler.record_function(
                        f"fedbench.kernel/{_name}"):
                    return _fn(*a, **kw)
            items.append((_Item(impls), "pallas", wrapped))
        return items

    def run(self):
        from torch.profiler import ProfilerActivity, profile, record_function

        from repro_torch.analysis import tracing
        from repro_torch.federated import simulator
        from fedbench.program_trace import Trace
        from fedbench.trace import read, summarize_read

        cell, me = self.cell, self
        dev = cell.device
        make_strategy = simulator.make_strategy
        make_local = simulator.make_local_train
        runner_cls = simulator.FederatedRunner
        host_batches, evaluate = runner_cls._host_batches, runner_cls._eval

        def span(name, fn):
            def run(*a, **kw):
                with record_function(f"fedbench/{name}"):
                    return fn(*a, **kw)
            return run

        def strategy(*a, **kw):
            strat = make_strategy(*a, **kw)
            on_stage = strat.on_stage

            def w_on_stage(state, stage):
                _sync(dev)
                t = time.perf_counter()
                with record_function("fedbench/stage_entry"):
                    on_stage(state, stage)
                    _sync(dev)
                me.stage_entry_s.append(time.perf_counter() - t)
            strat.on_stage = w_on_stage
            strat.aggregate = span("aggregate", strat.aggregate)
            return strat

        def local_train(sub_cfg, **kw):
            return span("local", make_local(sub_cfg, **kw))

        current = [None]

        def boundary(log):
            current[0].__exit__(None, None, None)
            current[0] = record_function("fedbench/round")
            current[0].__enter__()

        acts = [ProfilerActivity.CPU]
        if dev == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with patched((simulator, "make_strategy", strategy),
                     (simulator, "make_local_train", local_train),
                     (runner_cls, "_host_batches",
                      span("batches", host_batches)),
                     (runner_cls, "_eval", span("eval", evaluate)),
                     *self._kernel_patches()):
            _sync(dev)
            tracing.reset_counters()
            with profile(activities=acts) as prof:
                with record_function("fedbench/cycle"):
                    current[0] = record_function("fedbench/round")
                    current[0].__enter__()
                    cell.job(round_progress=boundary)
                    current[0].__exit__(None, None, None)
                    _sync(dev)
        t = time.perf_counter()
        self.counters = tracing.counters()
        recs = read(prof.profiler.kineto_results.events())
        self.summary = summarize_read(recs)
        self.trace = Trace.from_read(recs)
        self.program = self.trace.summary()
        self.read_s = time.perf_counter() - t


class _Item:
    """A registry entry's dict as an attribute owner for ``patched``."""

    def __init__(self, d):
        object.__setattr__(self, "_d", d)

    def __getattr__(self, k):
        return self._d[k]

    def __setattr__(self, k, v):
        self._d[k] = v


# ---------------------------------------------------------------------------
# one run of a cell
# ---------------------------------------------------------------------------

class Context:
    """What the per-layer readers read (``fedbench/metrics``): ``trace``,
    ``calls``, ``program`` and ``counters`` are a ``Traced`` cycle's
    readings (empty without one)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def run(cfg_doc: dict, reference: ModuleType, traffic: dict, seed: int,
        seconds: float, trace: bool, device: str, phases: Dict[str, float],
        kernel_files: Dict[str, Any], peaks: dict, limits: Dict[str, float]
        ) -> dict:
    """Set-up, the window, the traced cycle (``trace``), then the check.
    Returns the run's end-to-end values, the readers' context, the check's
    numbers and verdict, and the device's readings."""
    import gc

    from fedbench import check
    from fedbench.reference.fed import follow

    cell = Cell(cfg_doc, reference, traffic, seed, device, phases)
    t = time.perf_counter()
    cell.job(k_local=traffic["warmup_k_local"])
    _sync(device)
    phases["warmup_s"] = time.perf_counter() - t
    setup_end = time.perf_counter()

    capture = Capture(cell)
    win = Window(cell, seconds)
    win.run(capture)
    failed = sum(1 for r in win.rounds if not math.isfinite(r["eval"]))
    e2e = {"train_tokens_per_s": win.rate(),
           "peak_mem_gib": win.peak_bytes / 2 ** 30}
    traced = Traced(cell, kernel_files)
    if trace:
        traced.run()
    ctx = Context(method=traffic["spec"]["method"],
                  window_s=win.seconds_measured(), window_flops=win.flops(),
                  trace=traced.summary, calls=traced.calls,
                  program=traced.program, counters=traced.counters,
                  trace_read_s=traced.read_s,
                  stage_entry_s=traced.stage_entry_s,
                  kernel_files=kernel_files, peaks=peaks)
    del traced

    records = capture.records()
    del capture
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    with _no_tf32():
        ref = follow(cell.reference, cell.model, traffic, cell.params,
                     cell.lora0, cell.corpus, seed, records)
    nums = check.numbers(records, ref)
    correct, checks = check.judge(nums, limits)
    return {"setup_end": setup_end, "e2e": e2e, "ctx": ctx,
            "correct": correct and failed == 0, "checks": checks,
            "numbers": nums,
            "attempted": len(win.rounds), "failed": failed,
            "peak_bytes": win.peak_bytes, "reference_s":
            time.perf_counter() - t, "jobs": win.jobs,
            "window_rounds": win.rounds}


@contextlib.contextmanager
def _no_tf32():
    """f32 products in f32 (no TF32) for the reference."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c
