"""Share of the MoE slots routed in the traced cycle that dropped past
their expert's capacity, training and eval forwards together: the
program's counters ``moe.dropped_slots`` over ``moe.routed_slots``
(``repro_torch.analysis.tracing.counters``, reset before the cycle and
read after it). They count only while a profiler runs."""


def read(ctx):
    c = getattr(ctx, "counters", None) or {}
    if not c.get("moe.routed_slots"):
        return None
    return 100.0 * c["moe.dropped_slots"] / c["moe.routed_slots"]
