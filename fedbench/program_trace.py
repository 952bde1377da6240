"""The program's own spans in a traced cycle, read from the profiler's
events beside ``fedbench.trace.summarize``.

The port marks its round engine, stage entry, local step, MoE block and
training kernels with ``repro_torch/<name>`` ranges while a profiler runs
(``repro_torch.analysis.tracing``). :class:`Trace` reads them from the
same ``kineto_results.events()`` over the span ``fedbench/cycle``, and
:meth:`Trace.summary` returns, per span name:

* ``program_s``: device seconds of the operations launched inside one of
  its instances, child spans included, from any host thread (the
  autograd engine's too);
* ``program_bwd_s``: device seconds launched by backward nodes whose
  forward op ran with this span innermost, linked by the node's
  (``fwd_thread_id``, ``sequence_nr``); an operation already in the
  span's ``program_s`` (the recompute inside a custom backward) is not
  counted again;
* ``program_launches``: device operations, as ``program_s`` counts them;
* ``program_syncs``: synchronizing runtime calls (stream, device and
  event synchronizes, synchronous ``cudaMemcpy*``), each under its
  innermost span;
* ``program_calls``: instances;
* ``program_idle_gaps``: idle seconds of the device by the innermost
  span at the gap's middle (``none`` outside every span).

:func:`readings` turns a summary into the per-layer numbers these spans
were added for. The benchmark's traced cycle (``runners/federated.py``
``Traced``) reads its events through :class:`Trace` too, and its metric
files (``fedbench/metrics/``) read the summary from ``ctx.program``. Run
this module on its own to read a cell's spans in full, with the checks
that the spans agree with the harness's own labels:

    python3 fedbench/program_trace.py --workload <cell> --seed <n>

It runs the cell's set-up and warm-up, one traced cycle as ``--trace 1``
does, prints one JSON line and writes it to
``build/fedbench/program-<cell>-<seed>.json``.
"""
from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

ROOT = Path(__file__).resolve().parents[1]
if not __package__:                 # run as a script: the checkout's root
    sys.path.insert(0, str(ROOT))

from fedbench.trace import F32_GEMM, PROGRAM, _merge, read  # noqa: E402

#: a backward node's event; its (fwd_thread_id, sequence_nr) name the
#: forward op it differentiates
BACKWARD = "autograd::engine::evaluate_function: "
#: runtime calls after which the host has waited for the device
SYNC = re.compile(r"^cuda(StreamSynchronize|DeviceSynchronize|"
                  r"EventSynchronize|Memcpy(?!\w*Async)\w*)$")
#: the spans whose device time (and their backward's) is the MoE block
#: without its expert kernel
MOE_GLUE = ("moe.route", "moe.dispatch", "moe.combine")


def _stacks(spans: Sequence[tuple], times: Sequence[int]) -> List[tuple]:
    """For each time, the spans ``(start, end, ...)`` that hold it, by
    start (the innermost last)."""
    ss = sorted(spans)
    out: List[tuple] = [()] * len(times)
    active: tuple = ()
    i = 0
    for q in sorted(range(len(times)), key=times.__getitem__):
        t = times[q]
        while i < len(ss) and ss[i][0] <= t:
            active += (ss[i],)
            i += 1
        if any(s[1] < t for s in active):
            active = tuple(s for s in active if s[1] >= t)
        out[q] = active
    return out


class Trace:
    """The events of one traced cycle, sorted into device operations
    (each with the time the host launched it), the program's spans, the
    harness's spans, synchronizing calls and backward nodes."""

    def __init__(self, events):
        self._load(read(events))

    @classmethod
    def from_read(cls, recs: List[tuple]) -> "Trace":
        """The trace of events already read (``fedbench.trace.read``)."""
        trace = cls.__new__(cls)
        trace._load(recs)
        return trace

    def _load(self, recs: List[tuple]):
        dev, launch, op_start, fwd = [], {}, {}, {}
        self.spans: List[tuple] = []      # (start, end, name, thread)
        self.harness: List[tuple] = []    # (start, end, name)
        self.syncs: List[int] = []
        nodes = []                        # (start, end, fwd thread, seq)
        self.window: Optional[Tuple[int, int]] = None
        for rec in recs:
            name, a, b = rec[1], rec[2], rec[3]
            if rec[0]:
                if not name.startswith(PROGRAM):
                    dev.append((a, b, name, rec[4], rec[5]))
                continue
            if name.startswith(PROGRAM):
                self.spans.append((a, b, name[len(PROGRAM):], rec[7]))
            elif name == "fedbench/cycle":
                self.window = (a, b)
            elif name.startswith("fedbench/"):
                self.harness.append((a, b, name[len("fedbench/"):]))
            elif name.startswith("fedbench."):
                continue
            elif name.startswith(BACKWARD):
                if rec[5] >= 0:
                    nodes.append((a, b, rec[6], rec[5]))
            elif "Launch" in name or name.startswith(("cudaMemcpy",
                                                       "cudaMemset")):
                launch[rec[4]] = a
                if SYNC.match(name):
                    self.syncs.append(a)
            elif SYNC.match(name):
                self.syncs.append(a)
            else:
                op_start.setdefault(rec[4], a)
                if rec[5] >= 0 and rec[6] == 0:
                    # the latest op of a key made the node: a custom
                    # Function under no_grad records the number it peeks
                    key = (rec[7], rec[5])
                    fwd[key] = max(a, fwd.get(key, a))
        if self.window is None:
            self.ops: List[tuple] = []
            return
        w0, w1 = self.window
        self.spans = [s for s in self.spans if s[1] > w0 and s[0] < w1]
        self.syncs = [t for t in self.syncs if w0 <= t <= w1]
        dev = [d for d in dev if d[1] > w0 and d[0] < w1]
        self.busy = _merge([(max(a, w0), min(b, w1)) for a, b, *_ in dev])
        edges = [w0] + [x for iv in self.busy for x in iv] + [w1]
        self.gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2])
                     if b > a]
        # (launch time, seconds, name) of each operation the host launched
        self.ops = []
        for a, b, name, corr, linked in dev:
            t = launch.get(corr, op_start.get(linked))
            if t is not None:
                self.ops.append((t, (b - a) * 1e-9, name))
        # the forward op's start for the backward node that launched each
        # operation, where there is one
        node_of = _stacks(nodes, [t for t, *_ in self.ops])
        self.fwd_start = [fwd.get(st[-1][2:4]) if st else None
                          for st in node_of]

    def innermost(self, spans, times) -> List[str]:
        """The name of the innermost of ``spans`` at each time, else
        ``none``."""
        return [st[-1][2] if st else "none" for st in _stacks(spans, times)]

    def summary(self, only: Optional[Callable[[str], bool]] = None) -> Dict:
        """The ``program_*`` keys (see the module docstring) over the
        operations whose name ``only`` accepts (every operation by
        default; busy and idle time always count every operation)."""
        if self.window is None:
            return {}
        prog_s: Dict[str, float] = {}
        bwd_s: Dict[str, float] = {}
        launches: Dict[str, int] = {}
        keep = [i for i, op in enumerate(self.ops)
                if only is None or only(op[2])]
        held = _stacks(self.spans, [self.ops[i][0] for i in keep])
        fwd_in = dict(zip(
            (i for i in keep if self.fwd_start[i] is not None),
            self.innermost(self.spans, [self.fwd_start[i] for i in keep
                                        if self.fwd_start[i] is not None])))
        for i, st in zip(keep, held):
            dur = self.ops[i][1]
            names = {s[2] for s in st}
            for n in names:
                prog_s[n] = prog_s.get(n, 0.0) + dur
                launches[n] = launches.get(n, 0) + 1
            owner = fwd_in.get(i, "none")
            if owner != "none" and owner not in names:
                bwd_s[owner] = bwd_s.get(owner, 0.0) + dur
        syncs: Dict[str, int] = {}
        for n in self.innermost(self.spans, self.syncs):
            if n != "none":
                syncs[n] = syncs.get(n, 0) + 1
        calls: Dict[str, int] = {}
        for s in self.spans:
            calls[s[2]] = calls.get(s[2], 0) + 1
        idle: Dict[str, float] = {}
        mids = [(a + b) // 2 for a, b in self.gaps]
        for (a, b), n in zip(self.gaps, self.innermost(self.spans, mids)):
            idle[n] = idle.get(n, 0.0) + (b - a) * 1e-9
        return {"program_s": prog_s, "program_bwd_s": bwd_s,
                "program_launches": launches, "program_syncs": syncs,
                "program_calls": calls, "program_idle_gaps": idle}


def readings(prog: Dict, busy_s: float) -> Dict[str, Optional[float]]:
    """The per-layer numbers of a summary: ``lora_backward_pct`` (device
    time under ``kernel.lora_matmul.backward`` over busy),
    ``moe_dispatch_combine_pct`` (``program_s`` and ``program_bwd_s`` of
    the MoE block's routing, dispatch and combine over busy),
    ``step_launches`` (device operations a ``client.step``) and
    ``round_syncs`` (synchronizing calls inside program spans a round).
    None where the summary lacks what one reads."""
    s, calls = prog.get("program_s", {}), prog.get("program_calls", {})
    out: Dict[str, Optional[float]] = dict.fromkeys(
        ("lora_backward_pct", "moe_dispatch_combine_pct", "step_launches",
         "round_syncs"))
    if busy_s and "kernel.lora_matmul.backward" in s:
        out["lora_backward_pct"] = \
            100.0 * s["kernel.lora_matmul.backward"] / busy_s
    if busy_s and any(n in s for n in MOE_GLUE):
        bwd = prog.get("program_bwd_s", {})
        out["moe_dispatch_combine_pct"] = 100.0 * sum(
            s.get(n, 0.0) + bwd.get(n, 0.0) for n in MOE_GLUE) / busy_s
    if calls.get("client.step"):
        out["step_launches"] = prog["program_launches"].get(
            "client.step", 0) / calls["client.step"]
    if calls.get("round.local"):
        out["round_syncs"] = sum(prog["program_syncs"].values()) \
            / calls["round.local"]
    return out


def agreement(trace: Trace, old: Dict, prog: Dict) -> Dict:
    """What says that the spans sit where the harness measures: each
    kernel's device seconds under ``kernel.<name>`` against the harness
    label ``fedbench.kernel/<name>``, the host threads each kernel
    backward ran on against the step's, the f32 GEMM time
    (``fedbench.trace.F32_GEMM``) under each model span, and the share of
    the idle time the harness puts under ``local`` that a program span
    covers."""
    s = prog.get("program_s", {})
    kernels = {k: {"label_s": v, "span_s": s.get(f"kernel.{k}")}
               for k, v in old.get("label_s", {}).items()}
    threads: Dict[str, set] = {}
    for _, _, name, tid in trace.spans:
        threads.setdefault(name, set()).add(tid)
    f32 = {n: v for n, v in
           trace.summary(only=F32_GEMM.search)["program_s"].items()
           if n.startswith(("kernel.", "moe.", "step."))}
    mids = [(a + b) // 2 for a, b in trace.gaps]
    local = covered = 0.0
    for (a, b), h, p in zip(trace.gaps,
                            trace.innermost(trace.harness, mids),
                            trace.innermost(trace.spans, mids)):
        if h == "local":
            local += (b - a) * 1e-9
            covered += (b - a) * 1e-9 if p != "none" else 0.0
    return {
        "kernels": kernels,
        "threads": {n: sorted(t) for n, t in threads.items()
                    if n == "client.step" or n.endswith(".backward")},
        "f32_gemm_s": old.get("f32_gemm_s"),
        "f32_gemm_by_span_s": f32,
        "local_idle_s": local, "local_idle_covered_s": covered}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if str(ROOT / "src") not in sys.path:
        sys.path.insert(0, str(ROOT / "src"))
    import torch

    from fedbench.bench import Bench

    bench = Bench()
    cell_doc = bench.workload(args.workload)
    cfg_doc = bench.config(cell_doc["config"])
    traffic = bench.traffic(cell_doc["traffic"])
    runner = bench.runner(traffic)
    if args.device == "cuda":
        torch.cuda.set_device(0)
    torch.set_num_threads(min(4, torch.get_num_threads()))
    cell = runner.Cell(cfg_doc, bench.reference(cfg_doc), traffic, args.seed,
                       args.device, {})
    cell.job(k_local=traffic["warmup_k_local"])
    traced = runner.Traced(cell, bench.kernel_files())
    traced.run()
    old, prog = traced.summary, traced.program
    out = {"workload": args.workload, "seed": args.seed,
           "window_s": old.get("window_s"), "busy_s": old.get("busy_s"),
           "idle_gaps": old.get("idle_gaps"),
           "readings": dict(readings(prog, old.get("busy_s")),
                            moe_dropped_pct=bench.reader(
                                "moe_dropped_pct")(traced)),
           "agreement": agreement(traced.trace, old, prog),
           "counters": traced.counters, "read_s": traced.read_s, **prog}
    path = ROOT / "build" / "fedbench" / \
        f"program-{args.workload}-{args.seed}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
