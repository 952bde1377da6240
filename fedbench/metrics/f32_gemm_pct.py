"""Share of the traced cycle's device busy time in f32 cuBLAS GEMMs (the
plain f32 LoRA backward)."""


def read(ctx):
    t = ctx.trace
    if not t or not t.get("busy_s") or not t.get("f32_gemm_s"):
        return None
    return 100.0 * t["f32_gemm_s"] / t["busy_s"]
