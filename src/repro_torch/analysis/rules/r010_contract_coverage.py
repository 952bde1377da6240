"""R010 — every registry entry declares its contract (the JAX
package's rule; the serving detector keys on the port's step).

The contract layer (``--contracts``) can only verify surfaces that
*declare* what they promise. This rule closes the gap at the
registration sites themselves, statically:

* a module calling ``register_kernel("<name>", ...)`` must also call
  ``declare_kernel_contract("<name>", ...)`` for every distinct kernel
  name it registers;
* a class decorated ``@register(...)`` (the Strategy registry) must
  assign ``contract`` in its own class body — inheriting the base
  default silently is exactly how a method with non-standard uplink
  semantics would dodge verification;
* a class that defines the serving engine's step (``_step`` in the
  port; the JAX package keys on ``_build_step``, which builds its
  jitted step) must declare a ``contract`` class attribute.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.context import ModuleContext, call_name
from repro_torch.analysis.registry import rule

HINT = ("declare the surface's contract next to its registration: "
        "declare_kernel_contract(name, family=..., out=...) for "
        "kernels, `contract = AggregateContract(...)` in Strategy "
        "class bodies, `contract = StepContract(...)` on serving "
        "engines — python -m repro_torch.analysis --contracts verifies "
        "what is declared")

REGISTER_KERNEL = ("register_kernel", "dispatch.register_kernel")
DECLARE_KERNEL = ("declare_kernel_contract",
                  "dispatch.declare_kernel_contract")
STRATEGY_REGISTER = ("register", "registry.register", "methods.register")
#: the method that makes a class a serving engine
STEP_METHODS = ("_step",)


def _str_arg0(call: ast.Call):
    if call.args and isinstance(call.args[0], ast.Constant) \
            and isinstance(call.args[0].value, str):
        return call.args[0].value
    return None


def _assigns_name(cls: ast.ClassDef, name: str) -> bool:
    for stmt in cls.body:
        targets = []
        if isinstance(stmt, ast.Assign):
            targets = stmt.targets
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            targets = [stmt.target]
        for t in targets:
            if isinstance(t, ast.Name) and t.id == name:
                return True
    return False


@rule("R010", name="contract-coverage",
      summary="every registered kernel / Strategy / serving step "
              "declares the contract the contract layer verifies",
      hint=HINT,
      history="an undeclared surface is invisible to --contracts; the "
              "port's engine declared no StepContract and returned int64 "
              "next tokens where the JAX package's step returns int32")
def check(ctx: ModuleContext):
    findings = []

    # kernel registrations vs declarations, per module
    registered = {}           # name -> first registering call node
    declared = set()
    for node in ctx.walk():
        if not isinstance(node, ast.Call):
            continue
        cname = call_name(node)
        if cname in REGISTER_KERNEL:
            kname = _str_arg0(node)
            if kname is not None:
                registered.setdefault(kname, node)
        elif cname in DECLARE_KERNEL:
            kname = _str_arg0(node)
            if kname is not None:
                declared.add(kname)
    for kname, node in registered.items():
        if kname not in declared:
            findings.append(ctx.finding(
                "R010", node,
                f"kernel {kname!r} is registered but this module never "
                f"declares its contract "
                f"(declare_kernel_contract({kname!r}, ...))", HINT))

    for node in ctx.walk():
        if not isinstance(node, ast.ClassDef):
            continue
        is_strategy = any(
            isinstance(dec, ast.Call)
            and call_name(dec) in STRATEGY_REGISTER
            for dec in node.decorator_list)
        builds_step = any(
            isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef))
            and stmt.name in STEP_METHODS for stmt in node.body)
        if (is_strategy or builds_step) \
                and not _assigns_name(node, "contract"):
            what = "registered Strategy" if is_strategy \
                else "serving engine (defines _step)"
            findings.append(ctx.finding(
                "R010", node,
                f"{what} {node.name!r} declares no `contract` in its "
                f"class body", HINT))
    return findings
