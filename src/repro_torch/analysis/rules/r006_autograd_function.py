"""R006 — ``torch.autograd.Function`` forward/backward pairs must agree
on arity (the JAX package's custom_vjp rule, reread for torch).

Every kernel op on the port's training path pairs a Hopper forward with
a plain-version backward in an ``autograd.Function`` (``kernels/ops.py``;
``models/moe.py``'s collectives too). The failure mode is silent until
grad: a ``backward`` that returns one entry too few or too many only
raises when a training path first differentiates the op, often far from
the edit.

Checked in every class whose bases name ``autograd.Function``:

* each ``return`` of ``backward(ctx, *grads)`` that is a literal tuple
  has one entry per input of ``forward`` after ``ctx`` (every input of
  ``forward`` where the class defines ``setup_context``); a starred
  entry counts as the length of what it iterates over where that is
  ``ctx.needs_input_grad[:k]`` (also through a local name), a literal
  tuple or a literal list, and as unknown otherwise (the tuple is then
  checked only for having too many fixed entries);
* ``backward`` takes one gradient per output of ``forward`` wherever
  ``forward`` returns a literal tuple.
"""
from __future__ import annotations

import ast
from typing import Dict, Optional

from repro_torch.analysis.context import ModuleContext, dotted, own_nodes
from repro_torch.analysis.registry import rule

HINT = ("backward(ctx, *grads) returns one gradient (or None) per input "
        "of forward after ctx, and takes one gradient per output of "
        "forward")


def _is_function_class(cls: ast.ClassDef) -> bool:
    for base in cls.bases:
        name = dotted(base) or ""
        if name == "Function" or name.endswith("autograd.Function"):
            return True
    return False


def _method(cls: ast.ClassDef, name: str):
    for stmt in cls.body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and stmt.name == name:
            return stmt
    return None


def _slice_len(node: ast.AST) -> Optional[int]:
    """``ctx.needs_input_grad[:k]`` / ``[a:b]`` -> its length."""
    if not (isinstance(node, ast.Subscript)
            and (dotted(node.value) or "").endswith("needs_input_grad")
            and isinstance(node.slice, ast.Slice)
            and node.slice.step is None):
        return None
    lo, hi = node.slice.lower, node.slice.upper
    lo = 0 if lo is None else lo.value if isinstance(lo, ast.Constant) \
        else None
    hi = hi.value if isinstance(hi, ast.Constant) else None
    if not (isinstance(lo, int) and isinstance(hi, int)):
        return None
    return max(hi - lo, 0)


def _iter_len(node: ast.AST, names: Dict[str, ast.AST]) -> Optional[int]:
    """Length of an iterable expression, where the rule can tell."""
    if isinstance(node, ast.Name) and node.id in names:
        node = names[node.id]
    if isinstance(node, (ast.Tuple, ast.List)) \
            and not any(isinstance(e, ast.Starred) for e in node.elts):
        return len(node.elts)
    n = _slice_len(node)
    if n is not None:
        return n
    if isinstance(node, (ast.GeneratorExp, ast.ListComp)) \
            and len(node.generators) == 1 \
            and not node.generators[0].ifs:
        return _iter_len(node.generators[0].iter, names)
    return None


def _tuple_len(tup: ast.Tuple, names: Dict[str, ast.AST]):
    """-> (entries counted, whether every starred entry's length is
    known)."""
    total, known = 0, True
    for e in tup.elts:
        if isinstance(e, ast.Starred):
            n = _iter_len(e.value, names)
            known = known and n is not None
            total += n or 0
        else:
            total += 1
    return total, known


def _assigned(fn) -> Dict[str, ast.AST]:
    """Single-name assignments in ``fn``'s own body (last one wins)."""
    out: Dict[str, ast.AST] = {}
    for node in own_nodes(fn):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            out[node.targets[0].id] = node.value
    return out


def _tuple_returns(fn):
    for node in own_nodes(fn):
        if isinstance(node, ast.Return) and isinstance(node.value, ast.Tuple):
            yield node


@rule("R006", name="autograd-function-parity",
      summary="torch.autograd.Function backward returns a gradient count "
              "other than forward's inputs, or takes a gradient count "
              "other than forward's outputs",
      hint=HINT,
      history="the JAX package pairs every kernel's forward with a "
              "reference backward through custom_vjp, the port through "
              "autograd.Function; an arity slip only surfaces when "
              "training first differentiates the op")
def check(ctx: ModuleContext):
    findings = []
    for cls in ctx.walk():
        if not (isinstance(cls, ast.ClassDef) and _is_function_class(cls)):
            continue
        fwd, bwd = _method(cls, "forward"), _method(cls, "backward")
        if fwd is None or bwd is None or fwd.args.vararg is not None:
            continue
        has_ctx = _method(cls, "setup_context") is None
        n_in = len(fwd.args.args) - (1 if has_ctx else 0)
        names = _assigned(bwd)
        for ret in _tuple_returns(bwd):
            total, known = _tuple_len(ret.value, names)
            if total != n_in if known else total > n_in:
                findings.append(ctx.finding(
                    "R006", ret,
                    f"{cls.name}.backward returns {total}"
                    f"{'' if known else '+'} gradients, "
                    f"forward takes {n_in} inputs", HINT))
        if bwd.args.vararg is not None:
            continue
        n_grads = len(bwd.args.args) - 1
        for ret in _tuple_returns(fwd):
            total, known = _tuple_len(ret.value, _assigned(fwd))
            if known and total != n_grads:
                findings.append(ctx.finding(
                    "R006", bwd,
                    f"{cls.name}.backward takes {n_grads} gradients, "
                    f"forward returns {total} outputs", HINT))
    return findings
