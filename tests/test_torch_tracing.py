"""The port's spans and counters (``repro_torch.analysis.tracing``) and
the benchmark's reading of them (``fedbench/program_trace.py``), on the
CPU.

* With no profiler running, ``span`` is one shared no-op, nothing is
  recorded and the counters stay where they were.
* Under a CPU profiler, toy DevFT and FedIT jobs through
  ``run_experiment`` (the kernel branch forced, so the autograd
  Functions run their plain versions) record one ``client.step`` a local
  step, one ``devft.stage_entry`` a stage (none on FedIT), one
  ``kernel.lora_matmul.backward`` a training forward, and no span around
  the ``progress`` callback; their ``RoundLog``s and final LoRA are the
  bits of the same jobs unprofiled.
* The MoE counters equal a count from ``_dispatch_indices``.
* The summarizer on synthetic events: ``fedbench.trace.summarize``'s keys
  do not move when program spans join the events, a backward node's
  device work reaches the span its forward op ran in, synchronizing calls
  count under their span, and each reader gives None without its input.
"""
from __future__ import annotations

import dataclasses
import sys
import types
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from fedbench import program_trace as P  # noqa: E402
from fedbench.trace import summarize  # noqa: E402
from repro_torch.analysis import tracing  # noqa: E402
from repro_torch.experiments.runner import run_experiment  # noqa: E402
from repro_torch.experiments.spec import ExperimentSpec  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.models import moe as Moe  # noqa: E402

torch.set_num_threads(1)

TOY = {"n_layers": 2, "d_model": 32, "n_heads": 4, "n_kv_heads": 2,
       "d_ff": 64, "vocab": 64, "n_experts": 4, "top_k": 2}
SPEC = ExperimentSpec(arch="granite-moe-1b-a400m", reduced=TOY, layers=4,
                      rounds=4, n_stages=2, n_clients=4, sample_frac=0.5,
                      k_local=2, local_batch=2, seq=8, lora_rank=4,
                      pretrain_steps=0)


@pytest.fixture
def kernel_branch(monkeypatch):
    monkeypatch.setattr(dispatch, "use_kernel", lambda *a, **k: True)


def _moe_inputs(t=24):
    cfg = dataclasses.replace(SPEC.build_cfg(), kernel_backend="reference")
    gen = torch.Generator().manual_seed(3)
    params = Moe.init_moe(gen, cfg, torch.float32)
    return cfg, params, torch.randn(t, cfg.d_model, generator=gen)


# ---------------------------------------------------------------------------
# the program's spans and counters
# ---------------------------------------------------------------------------

def test_spans_off_record_nothing(monkeypatch, kernel_branch):
    assert tracing.span("client.step") is tracing.span("moe.route")
    assert not torch.autograd._profiler_enabled()
    opened = []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: opened.append(name) or real(name))
    before = tracing.counters()
    run_experiment(SPEC.replace(method="devft", rounds=2), device="cpu")
    cfg, params, x = _moe_inputs()
    Moe.moe_block(params, cfg, x, capacity=8)
    assert opened == []
    assert tracing.counters() == before


def _job(method, profiled):
    spec = SPEC.replace(method=method)
    if not profiled:
        return run_experiment(spec, device="cpu"), None
    marks = []

    def progress(log):
        with record_function("probe/progress"):
            marks.append(log.round)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("fedbench/cycle"):
            res = run_experiment(spec, device="cpu", round_progress=progress)
    assert len(marks) == spec.rounds
    return res, list(prof.profiler.kineto_results.events())


@pytest.fixture(scope="module")
def jobs():
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(dispatch, "use_kernel", lambda *a, **k: True)
        for method in ("devft", "fedit"):
            out[method] = (_job(method, False)[0], *_job(method, True))
    return out


@pytest.mark.parametrize("method", ["devft", "fedit"])
def test_job_spans(jobs, method):
    _, _, events = jobs[method]
    trace = P.Trace(events)
    calls = trace.summary()["program_calls"]
    n_clients = int(SPEC.n_clients * SPEC.sample_frac)
    assert calls["client.step"] == SPEC.rounds * n_clients * SPEC.k_local
    assert calls["client.train"] == SPEC.rounds * n_clients
    for name in ("round.batches", "round.local", "round.aggregate",
                 "round.post_round", "round.eval", "round.books"):
        assert calls[name] == SPEC.rounds, name
    assert calls.get("devft.stage_entry", 0) == \
        (SPEC.n_stages if method == "devft" else 0)
    for name in ("step.forward", "step.backward", "step.adamw"):
        assert calls[name] == calls["client.step"], name
    # one backward a training forward of the LoRA projection
    steps = [s for s in trace.spans if s[2] == "client.step"]
    fwd = [s for s in trace.spans if s[2] == "kernel.lora_matmul"]
    training = sum(any(a <= s[0] and s[1] <= b for a, b, *_ in steps)
                   for s in fwd)
    assert 0 < training < len(fwd)            # eval forwards run it too
    assert calls["kernel.lora_matmul.backward"] == training
    # the progress callback runs outside every program span
    probes = [(e.start_ns(), e.end_ns()) for e in events
              if e.name() == "probe/progress"]
    assert len(probes) == SPEC.rounds
    assert all(not (a <= p0 and p1 <= b)
               for p0, p1 in probes for a, b, *_ in trace.spans)


@pytest.mark.parametrize("method", ["devft", "fedit"])
def test_profiling_leaves_the_bits(jobs, method):
    off, on, _ = jobs[method]
    assert [dataclasses.astuple(x) for x in off.logs] == \
        [dataclasses.astuple(x) for x in on.logs]
    flat_off = dict(_flat(off.final_lora))
    flat_on = dict(_flat(on.final_lora))
    assert flat_off.keys() == flat_on.keys()
    assert all(torch.equal(flat_off[k], flat_on[k]) for k in flat_off)


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], path + (k,))
    else:
        yield path, tree


def test_moe_counters_match_dispatch_indices():
    cfg, params, x = _moe_inputs()
    _, idx, _ = Moe.router_topk(params, cfg, x)
    _, keep, _ = Moe._dispatch_indices(idx.reshape(-1), cfg.moe.n_experts, 8)
    dropped = int((~keep).sum())
    assert dropped > 0                         # the shape drops slots
    tracing.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        Moe.moe_block(params, cfg, x, capacity=8)
        Moe.moe_block(params, cfg, x, capacity=8)
    c = tracing.counters()
    assert (c["moe.routed_slots"], c["moe.dropped_slots"]) == \
        (2 * keep.numel(), 2 * dropped)
    tracing.reset_counters()
    assert (tracing.counters()["moe.routed_slots"],
            tracing.counters()["moe.dropped_slots"]) == (0, 0)


# ---------------------------------------------------------------------------
# the summarizer on synthetic events
# ---------------------------------------------------------------------------

class Ev:
    """A stand-in for a kineto event."""

    def __init__(self, name, a, b, *, dev=False, corr=0, linked=0, tid=1,
                 fwd_tid=0, seq=-1, kind="cpu_op"):
        self._n, self._a, self._b = name, a, b
        self._dev, self._corr, self._linked = dev, corr, linked
        self._tid, self._fwd, self._seq, self._kind = tid, fwd_tid, seq, kind

    def name(self):
        return self._n

    def start_ns(self):
        return self._a

    def end_ns(self):
        return self._b

    def device_type(self):
        return types.SimpleNamespace(name="CUDA" if self._dev else "CPU")

    def activity_type(self):
        return self._kind

    def correlation_id(self):
        return self._corr

    def linked_correlation_id(self):
        return self._linked

    def start_thread_id(self):
        return self._tid

    def fwd_thread_id(self):
        return self._fwd

    def sequence_nr(self):
        return self._seq


def _kernel(corr, t, a, b, name="gemm"):
    """A launch at host time t and its device operation over [a, b)."""
    return [Ev("cudaLaunchKernel", t, t + 1, corr=corr, kind="cuda_runtime"),
            Ev(name, a, b, dev=True, corr=corr, kind="kernel")]


def _events():
    """A cycle of 1000 ns: a harness ``local`` span and kernel label, a
    forward in ``moe.dispatch``, its backward node on another thread
    inside ``step.backward``, a custom backward that recomputes, and
    synchronizing calls."""
    harness = [Ev("fedbench/cycle", 0, 1000, kind="user_annotation"),
               Ev("fedbench/local", 100, 900, kind="user_annotation"),
               Ev("fedbench.kernel/lora_matmul", 150, 170,
                  kind="user_annotation"),
               *_kernel(1, 155, 200, 260, "lora_wgmma_kernel"),
               *_kernel(2, 210, 300, 340, "sm80_xmma_gemm_f32f32_f32"),
               *_kernel(3, 520, 600, 640),
               *_kernel(4, 560, 700, 720),
               Ev("_LoraMatmul", 100, 105, seq=7),   # under no_grad
               Ev("aten::index_put", 210, 230, seq=7),
               Ev(P.BACKWARD + "IndexPutBackward0", 500, 540, tid=2,
                  fwd_tid=1, seq=7),
               Ev(P.BACKWARD + "MmBackward0", 555, 570, tid=2, fwd_tid=2,
                  seq=3),
               Ev("aten::mm", 552, 554, tid=2, seq=3),
               Ev("cudaStreamSynchronize", 800, 810, kind="cuda_runtime"),
               Ev("cudaMemcpy", 820, 825, kind="cuda_runtime"),
               Ev("cudaMemcpyAsync", 830, 835, corr=9,
                  kind="cuda_runtime"),
               Ev("cudaDeviceSynchronize", 950, 960, kind="cuda_runtime")]
    program = [Ev("repro_torch/client.step", 140, 700,
                  kind="user_annotation"),
               Ev("repro_torch/moe.dispatch", 205, 235,
                  kind="user_annotation"),
               Ev("repro_torch/step.backward", 480, 700,
                  kind="user_annotation"),
               Ev("repro_torch/kernel.x.backward", 550, 580, tid=2,
                  kind="user_annotation"),
               Ev("repro_torch/round.eval", 790, 815,
                  kind="user_annotation"),
               Ev("repro_torch/round.to_device", 818, 840,
                  kind="user_annotation"),
               Ev("repro_torch/moe.dispatch", 300, 330, dev=True,
                  kind="gpu_user_annotation")]
    return harness, program


def test_old_keys_do_not_move_with_program_spans():
    harness, program = _events()
    alone = summarize(harness)
    both = summarize(harness + program)
    assert alone and both == alone
    assert alone["label_s"] == {"lora_matmul": pytest.approx(60e-9)}
    assert alone["f32_gemm_s"] == pytest.approx(40e-9)


def test_backward_work_reaches_the_forward_span():
    harness, program = _events()
    prog = P.Trace(harness + program).summary()
    s, bwd = prog["program_s"], prog["program_bwd_s"]
    # the forward's own launch inside moe.dispatch
    assert s["moe.dispatch"] == pytest.approx(40e-9)
    # IndexPutBackward0 (forward seq 7 on thread 1, in moe.dispatch, after
    # a no-grad op that peeked the same number) launched op 3 from
    # thread 2 inside step.backward
    assert s["step.backward"] == pytest.approx(60e-9)
    assert bwd["moe.dispatch"] == pytest.approx(40e-9)
    # the recompute's node (forward on thread 2 inside kernel.x.backward)
    # launched op 4 inside that span: counted there once, not as backward
    assert s["kernel.x.backward"] == pytest.approx(20e-9)
    assert "kernel.x.backward" not in bwd
    assert prog["program_launches"]["client.step"] == 4
    assert prog["program_calls"]["moe.dispatch"] == 1


def test_syncs_count_under_their_span():
    harness, program = _events()
    prog = P.Trace(harness + program).summary()
    assert prog["program_syncs"] == {"round.eval": 1, "round.to_device": 1}
    r = P.readings(dict(prog, program_calls={"round.local": 2}), 1e-6)
    assert r["round_syncs"] == 1.0


def test_idle_gaps_by_innermost_program_span():
    harness, program = _events()
    prog = P.Trace(harness + program).summary()
    idle = prog["program_idle_gaps"]
    assert sum(idle.values()) == pytest.approx(
        summarize(harness)["window_s"] - summarize(harness)["busy_s"])
    assert idle["client.step"] == pytest.approx(300e-9)  # 260..300, ..600
    assert idle["step.backward"] == pytest.approx(60e-9)  # 640..700
    assert idle["none"] == pytest.approx(480e-9)          # 0..200, 720..


def test_readers_give_none_without_input(monkeypatch):
    assert P.Trace([]).summary() == {}
    assert set(P.readings({}, 0.0).values()) == {None}
    from fedbench.bench import Bench

    read = Bench().reader("moe_dropped_pct")
    tracing.reset_counters()
    assert read(None) is None                  # nothing routed
    monkeypatch.delattr(tracing, "counters")
    assert read(None) is None                  # a program without counters
