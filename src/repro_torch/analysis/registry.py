"""Rule registry: one decorator, one flat namespace of rule IDs (the JAX
package's ``repro.analysis.registry``).

A rule is a function ``check(ctx: ModuleContext) -> Iterable[Finding]``
registered under a stable ID (``R00x``, the JAX package's ID for the
same bug class) with a summary, a fix hint and the *historical bug it
encodes*, and the source languages it reads (``python`` by default;
``cuda`` for the kernels under ``kernels/csrc/``).

Writing a new rule:

    from repro_torch.analysis.registry import rule

    @rule("R042", name="no-frobnication",
          summary="...", hint="...", history="PR n: ...")
    def check_frob(ctx):
        for node in ctx.walk():
            ...
            yield ctx.finding("R042", node, "frobnicated")

Drop the module into ``repro_torch/analysis/rules/`` and import it from
the package ``__init__`` — registration is the import side effect.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, List, Tuple

from repro_torch.analysis.context import ModuleContext
from repro_torch.analysis.findings import Finding

CheckFn = Callable[[ModuleContext], Iterable[Finding]]


@dataclasses.dataclass(frozen=True)
class Rule:
    id: str
    name: str
    summary: str
    hint: str
    history: str
    check: CheckFn
    languages: Tuple[str, ...] = ("python",)


_RULES: Dict[str, Rule] = {}


def rule(rule_id: str, *, name: str, summary: str, hint: str,
         history: str, languages: Tuple[str, ...] = ("python",)
         ) -> Callable[[CheckFn], CheckFn]:
    def deco(fn: CheckFn) -> CheckFn:
        if rule_id in _RULES:
            raise ValueError(f"duplicate rule id {rule_id!r} "
                             f"({_RULES[rule_id].name} vs {name})")
        _RULES[rule_id] = Rule(id=rule_id, name=name, summary=summary,
                               hint=hint, history=history, check=fn,
                               languages=tuple(languages))
        return fn
    return deco


def get_rule(rule_id: str) -> Rule:
    _load_builtin_rules()
    try:
        return _RULES[rule_id]
    except KeyError:
        raise KeyError(f"unknown rule {rule_id!r}; known: "
                       f"{[r.id for r in all_rules()]}") from None


def all_rules() -> List[Rule]:
    _load_builtin_rules()
    return [_RULES[k] for k in sorted(_RULES)]


def _load_builtin_rules() -> None:
    import repro_torch.analysis.rules  # noqa: F401  (registration side effect)
