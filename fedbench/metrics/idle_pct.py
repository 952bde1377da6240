"""Share of the traced cycle with no operation running on the device (the
union of the device operations' intervals)."""


def read(ctx):
    t = ctx.trace
    if not t or not t.get("window_s"):
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
