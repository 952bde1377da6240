"""R002 — one masking constant: ``repro_torch.kernels.common.NEG_INF``.

Raw ``-1e9`` / ``-1e30`` / ``float("-inf")`` / ``-torch.inf`` literals
in masking code drift between backends: the Hopper kernels, their plain
versions and the model layers must agree bit-for-bit on masked logits,
or fully masked rows and the parity with the JAX package silently
diverge. Only ``kernels/common.py`` — the constant's home — may spell
the literal in Python.

The port's masking also lives in CUDA: the attention kernels spell the
constant as ``kNegInf`` (``kernels/csrc/flash_attention.cu``,
``flash_decode.cu``). So the rule reads ``.cu``/``.cuh`` sources too,
with comments and strings skipped. There, a finite stand-in for minus
infinity (a float literal of magnitude >= 1e8 with a minus sign,
``-FLT_MAX``, ``-std::numeric_limits<float>::max()``) anywhere but the
value of a ``kNegInf`` definition is a finding, and so is a ``kNegInf``
whose value is not ``NEG_INF``. A true minus infinity (``-INFINITY``,
``-inf``, ``-HUGE_VALF``, ``-CUDART_INF_F``, ``-std::numeric_limits<
float>::infinity()``) is also the online softmax's running-max identity:
it is allowed as a declaration's initialiser, a comparison's operand or
a call's argument, and a finding where a statement stores it as a
masked score (``s[i] = -CUDART_INF_F;``).
"""
from __future__ import annotations

import ast
import re
import struct

from repro_torch.analysis.context import ModuleContext, call_name, dotted
from repro_torch.analysis.registry import rule
from repro_torch.kernels.common import NEG_INF

ALLOWED = ("kernels/common.py",)
THRESHOLD = 1e8        # catches -1e9 / -1e30 / -1e38; spares -65504 etc.
INF_ATTRS = ("torch.inf", "np.inf", "numpy.inf", "math.inf")

HINT = ("use NEG_INF from repro_torch.kernels.common (finite, bf16-safe, "
        "shared by kernels / plain versions / model layers); in CUDA, "
        "the kNegInf constant that equals it")

# CUDA: a minus sign (not an exponent's), then a decimal literal with
# its suffix
_CU_NUMBER = re.compile(
    r"(?<!\d[eE])(?<!\.[eE])-\s*"
    r"(?P<num>(?:\d+\.\d*|\.\d+|\d+)(?:[eE][+-]?\d+)?)(?P<suf>[fFlL]?)"
    r"(?![\w.])")
_CU_LIMITS = r"-\s*(?:std\s*::\s*)?numeric_limits\s*<\s*float\s*>\s*::\s*"
_CU_FINITE = re.compile(r"-\s*FLT_MAX\b|" + _CU_LIMITS + r"max\s*\(\s*\)")
_CU_INF = re.compile(r"-\s*(?:INFINITY|HUGE_VALF|CUDART_INF_F|inf)\b|"
                     + _CU_LIMITS + r"infinity\s*\(\s*\)")
# a statement that stores into an lvalue, up to its '=' (not '==', not a
# declaration: the lvalue follows a statement boundary directly)
_CU_STORE = re.compile(
    r"(?:[;{}]|\))\s*[A-Za-z_]\w*(?:(?:\.|->)\w+)*(?:\s*\[[^\]\n]*\])*"
    r"\s*=\s*$")
_CU_DEF = re.compile(
    r"(?:\b(?:constexpr|const)\b[^;{}]*?\bkNegInf\s*=(?!=)\s*"
    r"(?P<val>[^;]+?)\s*;)"
    r"|(?:^[ \t]*#[ \t]*define[ \t]+kNegInf[ \t]+(?P<mval>[^\n]+?)[ \t]*$)",
    re.MULTILINE)


def _is_float_inf_call(node: ast.AST, want: str) -> bool:
    return (isinstance(node, ast.Call) and call_name(node) == "float"
            and len(node.args) == 1
            and isinstance(node.args[0], ast.Constant)
            and node.args[0].value == want)


def _f32(x: float) -> float:
    return struct.unpack("f", struct.pack("f", x))[0]


def _literal_value(text: str):
    """The value of a C float literal (optional parentheses and suffix),
    or None if ``text`` is not one."""
    text = text.strip()
    while text.startswith("(") and text.endswith(")"):
        text = text[1:-1].strip()
    text = text.rstrip("fFlL")
    try:
        return float(text.replace(" ", ""))
    except ValueError:
        return None


def _check_python(ctx: ModuleContext):
    findings = []

    def flag(node, what):
        findings.append(ctx.finding(
            "R002", node, f"raw masking constant {what}", HINT))

    def visit(node: ast.AST):
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
            inner = node.operand
            if isinstance(inner, ast.Constant) \
                    and isinstance(inner.value, (int, float)) \
                    and abs(inner.value) >= THRESHOLD:
                flag(node, f"-{inner.value:g}")
                return
            if dotted(inner) in INF_ATTRS:
                flag(node, f"-{dotted(inner)}")
                return
            if _is_float_inf_call(inner, "inf"):
                flag(node, "-float('inf')")
                return
        if isinstance(node, ast.Constant) \
                and isinstance(node.value, (int, float)) \
                and not isinstance(node.value, bool) \
                and node.value <= -THRESHOLD:
            flag(node, f"{node.value:g}")
            return
        if _is_float_inf_call(node, "-inf"):
            flag(node, "float('-inf')")
            return
        for child in ast.iter_child_nodes(node):
            visit(child)

    visit(ctx.tree)
    return findings


def _check_cuda(ctx: ModuleContext):
    findings = []
    code = ctx.code
    allowed = []                 # (start, end) of kNegInf definitions' values
    for m in _CU_DEF.finditer(code):
        group = "val" if m.group("val") is not None else "mval"
        start, end = m.span(group)
        allowed.append((start, end))
        value = _literal_value(m.group(group))
        if value is None or _f32(value) != _f32(NEG_INF):
            line, col = ctx.line_col(start)
            findings.append(ctx.finding_at(
                "R002", line, col,
                f"kNegInf = {m.group(group).strip()} differs from NEG_INF "
                f"({NEG_INF:g})", HINT))

    def inside_def(pos: int) -> bool:
        return any(a <= pos < b for a, b in allowed)

    hits = []
    for m in _CU_NUMBER.finditer(code):
        num, suf = m.group("num"), m.group("suf")
        is_float = "." in num or "e" in num.lower() or suf in ("f", "F")
        if is_float and float(num) >= THRESHOLD:
            hits.append((m.start(), f"-{num}{suf}"))
    for m in _CU_FINITE.finditer(code):
        hits.append((m.start(), re.sub(r"\s+", "", m.group(0))))
    for m in _CU_INF.finditer(code):
        if _CU_STORE.search(code, max(0, m.start() - 200), m.start()):
            hits.append((m.start(), re.sub(r"\s+", "", m.group(0))))
    for pos, what in sorted(hits):
        if inside_def(pos):
            continue
        line, col = ctx.line_col(pos)
        findings.append(ctx.finding_at(
            "R002", line, col, f"raw masking constant {what}", HINT))
    return findings


@rule("R002", name="single-masking-constant",
      summary="raw -1e9/-1e30/float('-inf')/-inf literals outside "
              "kernels/common.py; in the CUDA kernels, a finite stand-in "
              "anywhere but a kNegInf equal to NEG_INF, or -inf stored as "
              "a masked score (masking-value drift between backends)",
      hint=HINT,
      history="the JAX package once had inconsistent NEG_INF literals "
              "that left fully-masked attention rows emitting uniform-"
              "softmax garbage; the port's kernels spell the constant "
              "again, in CUDA",
      languages=("python", "cuda"))
def check(ctx: ModuleContext):
    if ctx.language == "cuda":
        return _check_cuda(ctx)
    if ctx.path_endswith(*ALLOWED):
        return []
    return _check_python(ctx)
