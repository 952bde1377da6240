"""``<kernel>_roofline``: the least time of the traced cycle's calls of a
registry kernel (per call the larger of its operations over the peak of
the dtype it ran and its bytes over the memory bandwidth, counted by
``fedbench/kernels/<kernel>.py``) over the device time of the operations
launched under its label."""


def read(ctx, kernel):
    calls = ctx.calls.get(kernel)
    dev = (ctx.trace or {}).get("label_s", {}).get(kernel)
    mod = ctx.kernel_files.get(kernel)
    if not calls or not dev or mod is None:
        return None
    least = 0.0
    for rec in calls:
        ops, nbytes, dtype = mod.count(rec)
        least += max(ops / ctx.peaks["flops"][dtype],
                     nbytes / ctx.peaks["bytes_per_s"])
    return 100.0 * least / dev
