"""moe_expert_ffn: SwiGLU over per-expert buffers buf (E, C, d) with wg,
wu (E, d, ff) and wd (E, ff, d); only each expert's live rows (``fill``)
count, and only the weights of experts with a live row are read."""


def record(args, kwargs):
    buf, wg = args[0], args[1]
    return {"e": buf.shape[0], "c": buf.shape[1], "d": buf.shape[2],
            "ff": wg.shape[2], "fill": kwargs.get("fill"),
            "elt": buf.element_size(),
            "dtype": str(buf.dtype).replace("torch.", "")}


def count(rec):
    e, c, d, ff = rec["e"], rec["c"], rec["d"], rec["ff"]
    fill = rec["fill"]
    if fill is None:
        live, experts = e * c, e
    else:
        rows = [min(int(f), c) for f in fill.tolist()]
        live, experts = sum(rows), sum(1 for f in rows if f > 0)
    ops = 6 * live * d * ff
    nbytes = rec["elt"] * (2 * live * d + experts * 3 * d * ff)
    return ops, nbytes, rec["dtype"]
