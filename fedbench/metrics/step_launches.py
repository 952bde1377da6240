"""Device operations a local step in the traced cycle: those launched
inside the program's ``client.step`` spans over their instances
(``fedbench.program_trace``)."""
from fedbench.program_trace import readings


def read(ctx):
    return readings(ctx.program, ctx.trace.get("busy_s"))["step_launches"]
