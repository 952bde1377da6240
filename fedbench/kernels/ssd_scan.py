"""ssd_scan: the chunked SSD scan over x (B, S, H, P), dt (B, S, H) f32,
b and c (B, S, G, N): within a chunk the causal half of C B^T and its
product with x, across chunks the states and their output."""


def record(args, kwargs):
    x, dt, _a, b = args[:4]
    bs, s, h, p = x.shape
    return {"b": bs, "s": s, "h": h, "p": p, "g": b.shape[2], "n": b.shape[3],
            "chunk": int(kwargs.get("chunk", 128)), "elt": x.element_size(),
            "elt_bc": b.element_size(), "elt_dt": dt.element_size(),
            "dtype": str(x.dtype).replace("torch.", "")}


def count(rec):
    bs, s, h, p, g, n = (rec[k] for k in ("b", "s", "h", "p", "g", "n"))
    q = min(rec["chunk"], s)
    ops = bs * s * h * (q * (n + p) + 4 * p * n)
    nbytes = (rec["elt"] * 2 * bs * s * h * p + rec["elt_dt"] * bs * s * h
              + rec["elt_bc"] * 2 * bs * s * g * n)
    return ops, nbytes, rec["dtype"]
