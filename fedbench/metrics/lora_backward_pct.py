"""Share of the traced cycle's device busy time launched inside the
program's ``kernel.lora_matmul.backward`` spans: the LoRA backward, its
input-gradient kernel and its plain products (``fedbench.program_trace``)."""
from fedbench.program_trace import readings


def read(ctx):
    return readings(ctx.program, ctx.trace.get("busy_s"))["lora_backward_pct"]
