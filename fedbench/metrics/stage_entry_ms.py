"""Mean wall of one stage entry (the strategy's ``on_stage``: the transfer
back of the finished stage, then grouping and fusion), synchronized on
both sides, over the traced cycle."""


def read(ctx):
    walls = ctx.stage_entry_s
    if not walls or ctx.method != "devft":
        return None
    return 1e3 * sum(walls) / len(walls)
