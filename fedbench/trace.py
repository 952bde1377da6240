"""The traced run's reading of the profiler: device busy time as the union
of the device operations' intervals, the operations that took most time,
the idle gaps by the harness span the host was in, and the device time
of the kernels launched under each registry label.

The harness marks its spans (``SPAN``) and each registry kernel call
(``KERNEL``) with ``torch.profiler.record_function``; a device operation
belongs to a label when the host launched it inside the label's range.

:func:`read` takes from the profiler's events, once, the fields that
this summary and the program's (``fedbench.program_trace.Trace``) use:
each field is a call into the profiler's C++ side, and a traced cycle
holds millions of events.
"""
from __future__ import annotations

import bisect
import re
from typing import Dict, List, Tuple

SPAN = "fedbench/"
KERNEL = "fedbench.kernel/"
#: the prefix of the program's own spans (``repro_torch.analysis.tracing``)
PROGRAM = "repro_torch/"
#: f32 cuBLAS GEMMs (SIMT/FFMA tiles): the plain f32 LoRA backward
F32_GEMM = re.compile(r"sgemm|gemm_f32f32|f32f32_f32|ffma", re.I)


def _merge(iv: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _innermost(spans, t):
    """The name of the latest-starting span that holds time ``t``."""
    best = None
    for name, a, b in spans:
        if a <= t <= b and (best is None or a >= best[1]):
            best = (name, a)
    return best[0] if best else "none"


def _annotation(e) -> bool:
    """A device-side copy of a host annotation (not an operation)."""
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return "annotation" in str(kind())
    flag = getattr(e, "is_user_annotation", None)
    return bool(flag()) if flag is not None else False


def read(events) -> List[tuple]:
    """The fields of ``profiler.kineto_results.events()`` the summaries
    read, one tuple an event, in order: ``(True, name, start, end,
    correlation id, linked correlation id)`` for a device operation
    (positive length, no ``fedbench``/``ProfilerStep`` name, not an
    annotation; other device events are left out), ``(False, name, start,
    end, correlation id, sequence number, forward thread, thread)`` for a
    host event, the forward thread read where the sequence number is set
    and the thread for a program span or an op of the forward (else 0)."""
    out: List[tuple] = []
    for e in events:
        name = e.name()
        a, b = e.start_ns(), e.end_ns()
        if e.device_type().name in ("CUDA", "PrivateUse1"):
            if b > a and not name.startswith(("fedbench", "ProfilerStep")) \
                    and not _annotation(e):
                out.append((True, name, a, b, e.correlation_id(),
                            e.linked_correlation_id()))
            continue
        seq = e.sequence_nr()
        fwd = e.fwd_thread_id() if seq >= 0 else 0
        tid = e.start_thread_id() if name.startswith(PROGRAM) \
            or (seq >= 0 and fwd == 0) else 0
        out.append((False, name, a, b, e.correlation_id(), seq, fwd, tid))
    return out


def summarize(events, n_top: int = 10) -> Dict:
    """The summary of ``profiler.kineto_results.events()`` over the span
    ``fedbench/cycle``: busy and window seconds, the top device
    operations, idle seconds by host span, device seconds by kernel label
    and in f32 GEMMs, and the count of device operations."""
    return summarize_read(read(events), n_top)


def summarize_read(recs: List[tuple], n_top: int = 10) -> Dict:
    """:func:`summarize` of events already :func:`read`."""
    dev, spans, labels = [], [], []
    launch, op_start = {}, {}
    for rec in recs:
        name, a = rec[1], rec[2]
        if rec[0]:
            dev.append((a, rec[3], name, rec[4], rec[5]))
        elif name.startswith(KERNEL):
            labels.append((a, rec[3], name[len(KERNEL):]))
        elif name.startswith(SPAN):
            spans.append((name[len(SPAN):], a, rec[3]))
        elif "Launch" in name or name.startswith(("cudaMemcpy", "cudaMemset")):
            launch[rec[4]] = a
        else:
            op_start.setdefault(rec[4], a)
    cycle = [(a, b) for n, a, b in spans if n == "cycle"]
    if not cycle or not dev:
        return {}
    w0, w1 = cycle[0]
    dev = [d for d in dev if d[1] > w0 and d[0] < w1]
    busy_iv = _merge([(max(a, w0), min(b, w1)) for a, b, *_ in dev])
    busy = sum(b - a for a, b in busy_iv)
    by_name: Dict[str, float] = {}
    for a, b, name, *_ in dev:
        by_name[name] = by_name.get(name, 0) + (b - a)
    f32 = sum(t for n, t in by_name.items() if F32_GEMM.search(n))
    # idle gaps by the host span in progress at their middle
    gaps: Dict[str, float] = {}
    edges = [w0] + [x for iv in busy_iv for x in iv] + [w1]
    inner = [s for s in spans if s[0] != "cycle"]
    for a, b in zip(edges[::2], edges[1::2]):
        if b > a:
            who = _innermost(inner, (a + b) // 2)
            gaps[who] = gaps.get(who, 0) + (b - a)
    # device time by kernel label, through the host launch of each op
    labels.sort()
    starts = [x[0] for x in labels]
    by_label: Dict[str, float] = {}
    for a, b, _, corr, linked in dev:
        t = launch.get(corr, op_start.get(linked))
        if t is None:
            continue
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and labels[i][0] <= t <= labels[i][1]:
            by_label[labels[i][2]] = by_label.get(labels[i][2], 0) + (b - a)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n_top]
    return {
        "window_s": (w1 - w0) * 1e-9, "busy_s": busy * 1e-9,
        "device_ops": [[n, t * 1e-9] for n, t in top],
        "idle_gaps": [[n, t * 1e-9] for n, t in
                      sorted(gaps.items(), key=lambda kv: -kv[1])[:n_top]],
        "label_s": {k: v * 1e-9 for k, v in by_label.items()},
        "f32_gemm_s": f32 * 1e-9, "n_device_ops": len(dev),
        "spans_s": _span_totals(inner),
    }


def _span_totals(spans) -> Dict[str, List[float]]:
    out: Dict[str, List[float]] = {}
    for name, a, b in spans:
        out.setdefault(name, []).append((b - a) * 1e-9)
    return out
