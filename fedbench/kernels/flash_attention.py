"""flash_attention: q (B, S, H, D), k and v (B, S, Hkv, D), causal or
not; QK^T and PV over the live part of the score matrix."""


def record(args, kwargs):
    q, k = args[0], args[1]
    b, s, h, d = q.shape
    return {"b": b, "s": s, "h": h, "hkv": k.shape[2], "d": d,
            "causal": bool(kwargs.get("causal", True)),
            "window": kwargs.get("window"), "elt": q.element_size(),
            "dtype": str(q.dtype).replace("torch.", "")}


def count(rec):
    b, s, h, hkv, d = rec["b"], rec["s"], rec["h"], rec["hkv"], rec["d"]
    if rec["window"]:
        w = min(rec["window"], s)
        pairs = w * (w + 1) // 2 + (s - w) * w
    elif rec["causal"]:
        pairs = s * (s + 1) // 2
    else:
        pairs = s * s
    ops = 4 * b * h * d * pairs
    nbytes = rec["elt"] * b * s * d * (2 * h + 2 * hkv)
    return ops, nbytes, rec["dtype"]
