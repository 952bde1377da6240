"""Contract driver: enumerate every declared surface, check each one,
return Findings + enumeration stats (the JAX package's
``contracts/driver.py``).

``python -m repro_torch.analysis --contracts`` routes the findings
through the same baseline/exit-code machinery as the AST rules, and
prints the stats so the coverage claim shows, not just "0 findings".
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from repro_torch.analysis.findings import Finding

#: rule id -> one-line description (the JAX package's C001-C003; its
#: C004/C005 check ``cache_key()``, which the port does not have)
CONTRACT_RULES = {
    "C001": "kernel registry: every backend satisfies the declared "
            "KernelContract over its shape family (meta tensors: the "
            "plain versions and the dry-run's stand-ins; cuda: the hand "
            "kernels)",
    "C002": "strategy round programs (on meta tensors): aggregated tree "
            "keeps the global adapters' shapes and dtypes; uplink bytes "
            "a Python int",
    "C003": "serving step: int32 next tokens, the cache's shapes and "
            "dtypes kept, across arch families and adapter modes",
}


def run_contracts(device="meta") -> Tuple[List[Finding], Dict[str, int]]:
    """C001 and C003 on ``device``; C002 on meta (its round programs
    train every client of every cell: too much for a point check on the
    card)."""
    from repro_torch.analysis.contracts.kernels import check_kernels
    from repro_torch.analysis.contracts.serving import check_serving
    from repro_torch.analysis.contracts.strategies import check_strategies

    findings: List[Finding] = []
    stats: Dict[str, int] = {}
    for check in (lambda: check_kernels(device), check_strategies,
                  lambda: check_serving(device)):
        f, s = check()
        findings.extend(f)
        stats.update(s)
    return findings, stats
