"""``repro_torch.analysis`` — the port's own lint and contract layer (the
JAX package's ``repro.analysis``, the checks that have a torch meaning).

Static side: the AST rules R001 (keyed seed streams), R002 (one masking
constant, read in the CUDA kernels too), R006 (``autograd.Function``
arity) and R010 (every registered surface declares its contract), under
the JAX package's IDs. ``python -m repro_torch.analysis`` runs them
over ``src/repro_torch`` and exits 1 on any non-baselined finding.

Contract side (``--contracts``): C001 (every kernel backend against its
``KernelContract``, over meta tensors on the CPU and over real tensors
on the card), C002 (every strategy's round program on meta tensors) and
C003 (the serving step's ``StepContract``).

Runtime side (``tracing``): the program's spans (:func:`span`, on only
while a profiler runs) and counters (:func:`counters`,
:func:`reset_counters`), and :func:`guard_syncs` /
:func:`no_implicit_syncs`, over ``torch.cuda.set_sync_debug_mode``. The JAX package's
``CompileCounter`` has no counterpart: nothing in the port compiles.

Not carried over, having no torch meaning: ``analysis/lowered/`` (XLA
lowerings, collective fingerprints, the Pallas layout lint, donation
aliasing), R003/C004/C005 (``cache_key()``; the port has no jit
cache), R004 (donation), R005, R007, R008 and R009 (jit tracing, weak
types, static arguments).
"""
from repro_torch.analysis.core import (
    DEFAULT_BASELINE,
    DEFAULT_TARGET,
    analyze_file,
    analyze_paths,
    analyze_source,
)
from repro_torch.analysis.findings import (
    Finding,
    apply_baseline,
    load_baseline,
    save_baseline,
)
from repro_torch.analysis.registry import Rule, all_rules, get_rule, rule
from repro_torch.analysis.tracing import (counters, guard_syncs,
                                         no_implicit_syncs, reset_counters,
                                         span)

__all__ = [
    "DEFAULT_BASELINE", "DEFAULT_TARGET",
    "analyze_file", "analyze_paths", "analyze_source",
    "Finding", "apply_baseline", "load_baseline", "save_baseline",
    "Rule", "all_rules", "get_rule", "rule",
    "counters", "guard_syncs", "no_implicit_syncs", "reset_counters", "span",
]
