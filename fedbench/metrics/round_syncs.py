"""Synchronizing runtime calls a round's client loop in the traced cycle:
those made inside any of the program's spans over the instances of
``round.local`` (``fedbench.program_trace``)."""
from fedbench.program_trace import readings


def read(ctx):
    return readings(ctx.program, ctx.trace.get("busy_s"))["round_syncs"]
