"""Share of the MoE slots routed in the traced cycle that dropped past
their expert's capacity, training and eval forwards together: the
program's counters ``moe.dropped_slots`` over ``moe.routed_slots``
(``repro_torch.analysis.tracing.counters``). They count only while a
profiler runs, so in a run of the benchmark over the traced cycle alone."""
import importlib


def read(ctx):
    try:
        tracing = importlib.import_module("repro_torch.analysis.tracing")
    except ImportError:
        return None
    counters = getattr(tracing, "counters", None)
    if counters is None:
        return None
    c = counters()
    if not c.get("moe.routed_slots"):
        return None
    return 100.0 * c["moe.dropped_slots"] / c["moe.routed_slots"]
