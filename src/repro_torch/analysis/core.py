"""Analysis driver: run rules over files, sources, or trees (the JAX
package's ``repro.analysis.core``). Directories are read for Python
(``*.py``) and CUDA (``*.cu``, ``*.cuh``) sources; each rule sees the
languages it declares."""
from __future__ import annotations

from pathlib import Path
from typing import Iterable, List, Optional, Sequence

from repro_torch.analysis.context import (CUDA_SUFFIXES, REPO_ROOT,
                                          ModuleContext)
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.registry import Rule, all_rules, get_rule

#: the tree the bare invocation checks: the port's package
DEFAULT_TARGET = (REPO_ROOT / "src" / "repro_torch",)
DEFAULT_BASELINE = Path(__file__).resolve().parent / "baseline.json"

SOURCE_SUFFIXES = (".py", *CUDA_SUFFIXES)


def _select(rules: Optional[Sequence[str]]) -> List[Rule]:
    if rules is None:
        return all_rules()
    return [get_rule(r) for r in rules]


def analyze_source(source: str, path: str = "<snippet>", *,
                   rules: Optional[Sequence[str]] = None) -> List[Finding]:
    """Run (selected) rules over one source string; ``path``'s suffix
    says its language (``.cu``/``.cuh``: CUDA, else Python)."""
    ctx = ModuleContext(source, path)
    out: List[Finding] = []
    for r in _select(rules):
        if ctx.language in r.languages:
            out.extend(r.check(ctx))
    return sorted(out, key=lambda f: (f.path, f.line, f.col, f.rule))


def analyze_file(path, *, rules: Optional[Sequence[str]] = None
                 ) -> List[Finding]:
    with open(path) as f:
        return analyze_source(f.read(), str(path), rules=rules)


def iter_source_files(paths: Iterable) -> List[Path]:
    out: List[Path] = []
    for p in paths:
        p = Path(p)
        if p.is_dir():
            out.extend(sorted(f for f in p.rglob("*")
                              if f.suffix in SOURCE_SUFFIXES
                              and f.is_file()))
        else:
            out.append(p)
    return out


def analyze_paths(paths: Iterable, *,
                  rules: Optional[Sequence[str]] = None) -> List[Finding]:
    """Run rules over files/directories (dirs recurse into Python and
    CUDA sources)."""
    out: List[Finding] = []
    for f in iter_source_files(paths):
        out.extend(analyze_file(f, rules=rules))
    return out
