"""Share of the traced cycle's device busy time in the MoE block without
its expert kernel: the device time of the program's ``moe.route``,
``moe.dispatch`` and ``moe.combine`` spans and of their backward
(``fedbench.program_trace``)."""
from fedbench.program_trace import readings


def read(ctx):
    return readings(ctx.program,
                    ctx.trace.get("busy_s"))["moe_dispatch_combine_pct"]
