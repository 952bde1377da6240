"""Share of the traced cycle's device busy time in MLA's training
attention (``fedbench.program_trace``'s summary): the device time inside
the program's ``mla.latent``, ``mla.expand`` and ``mla.attend`` spans
(``program_s``: the forward, its kernels included), the backward of the
latent and expansion ops (``program_bwd_s``; the LoRA backward of
``wq_b``/``wkv_b`` is linked whole to ``mla.expand``), and the attention's
backward, read from the span ``kernel.flash_attention.backward`` (in the
cells this metric lists every ``flash_attention`` call is MLA's). The
backward of ``mla.attend`` is left out: the profiler links to it the
device work the flash backward's autograd node launches itself (its
recompute), which that span holds already, and beside it only the
slice's gradient. None where the trace has no MLA span."""

SPANS = ("mla.latent", "mla.expand", "mla.attend")
BACKWARD = ("mla.latent", "mla.expand")
ATTENTION_BACKWARD = "kernel.flash_attention.backward"


def read(ctx):
    prog = getattr(ctx, "program", None) or {}
    s, bwd = prog.get("program_s", {}), prog.get("program_bwd_s", {})
    busy = (getattr(ctx, "trace", None) or {}).get("busy_s")
    if not busy or not any(n in s for n in SPANS):
        return None
    total = sum(s.get(n, 0.0) for n in SPANS) \
        + sum(bwd.get(n, 0.0) for n in BACKWARD) \
        + s.get(ATTENTION_BACKWARD, 0.0)
    return 100.0 * total / busy
