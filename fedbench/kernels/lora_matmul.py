"""lora_matmul: x (M, K) @ w (K, N) plus the rank-r bypass (x @ a) @ b."""
import math


def record(args, kwargs):
    x, w, a, b = args[:4]
    return {"m": math.prod(x.shape[:-1]), "k": w.shape[0], "n": w.shape[1],
            "r": a.shape[1], "elt": x.element_size(),
            "dtype": str(x.dtype).replace("torch.", "")}


def count(rec):
    m, k, n, r = rec["m"], rec["k"], rec["n"], rec["r"]
    ops = 2 * m * (k * n + k * r + r * n)
    nbytes = rec["elt"] * (m * k + k * n + k * r + r * n + m * n)
    return ops, nbytes, rec["dtype"]
