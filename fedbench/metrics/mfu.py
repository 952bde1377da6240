"""The window's model FLOPs (``fedbench.flops``: forward and backward of
every local step, the eval forwards) over its seconds, as a share of the
card's dense bf16 peak."""


def read(ctx):
    if not ctx.window_s or not ctx.window_flops:
        return None
    return 100.0 * ctx.window_flops / ctx.window_s / ctx.peaks["flops"]["bfloat16"]
