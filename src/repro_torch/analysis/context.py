"""Per-module analysis context and the shared AST helpers rules use (the
JAX package's ``repro.analysis.context``).

One :class:`ModuleContext` wraps one source file: the repo-relative
path, the source lines and, for Python, the parsed AST with the
resolution helpers more than one rule needs (dotted-name rendering,
module-wide function maps). A CUDA source (``.cu``/``.cuh``) has no
AST: its context says ``language == "cuda"`` and carries the text with
its comments and string literals blanked (``code``), for the rules that
read the kernels too (R002).

The JAX package's traced-context discovery (``traced_functions``,
``is_jit_decorator``) finds the bodies that run under a jax trace; eager
torch traces nothing, so it is not carried over.
"""
from __future__ import annotations

import ast
from pathlib import Path, PurePosixPath
from typing import Dict, Iterator, List, Optional

from repro_torch.analysis.findings import Finding

# repo root = parents[3] of this file (src/repro_torch/analysis/context.py)
REPO_ROOT = Path(__file__).resolve().parents[3]

FunctionNode = (ast.FunctionDef, ast.AsyncFunctionDef)

#: suffixes read as CUDA C++ (everything else is read as Python)
CUDA_SUFFIXES = (".cu", ".cuh")


def rel_path(path: str) -> str:
    """Repo-root-relative posix path when the file lives in the repo
    (stable baseline keys); the given path otherwise (snippets, tmp)."""
    try:
        p = Path(path).resolve()
        return str(PurePosixPath(p.relative_to(REPO_ROOT)))
    except (ValueError, OSError):
        return str(PurePosixPath(path))


def language_of(path: str) -> str:
    return "cuda" if str(path).endswith(CUDA_SUFFIXES) else "python"


def blank_comments(source: str) -> str:
    """C/C++ ``source`` with every comment and string or character
    literal replaced by spaces (newlines kept), so offsets, lines and
    columns stay those of the original text."""
    out = list(source)
    i, n = 0, len(source)

    def blank(a: int, b: int) -> None:
        for j in range(a, b):
            if out[j] != "\n":
                out[j] = " "

    while i < n:
        c = source[i]
        two = source[i:i + 2]
        if two == "//":
            end = source.find("\n", i)
            end = n if end < 0 else end
            blank(i, end)
            i = end
        elif two == "/*":
            end = source.find("*/", i + 2)
            end = n if end < 0 else end + 2
            blank(i, end)
            i = end
        elif c in "\"'":
            j = i + 1
            while j < n and source[j] != c and source[j] != "\n":
                j += 2 if source[j] == "\\" else 1
            blank(i, min(j + 1, n))
            i = j + 1
        else:
            i += 1
    return "".join(out)


def dotted(node: ast.AST) -> Optional[str]:
    """Render a Name/Attribute chain as ``a.b.c`` (None if the chain
    bottoms out in anything else, e.g. a call result)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def call_name(node: ast.Call) -> Optional[str]:
    return dotted(node.func)


def const_ints(node: ast.AST) -> Optional[List[int]]:
    """Literal int or tuple/list of literal ints -> [ints] (else None)."""
    if isinstance(node, ast.Constant) and isinstance(node.value, int) \
            and not isinstance(node.value, bool):
        return [node.value]
    if isinstance(node, (ast.Tuple, ast.List)):
        out = []
        for e in node.elts:
            if not (isinstance(e, ast.Constant)
                    and isinstance(e.value, int)):
                return None
            out.append(e.value)
        return out
    return None


def decorator_calls(fn: ast.AST) -> Iterator[ast.expr]:
    for dec in getattr(fn, "decorator_list", []):
        yield dec


def own_nodes(fn: ast.AST) -> Iterator[ast.AST]:
    """The nodes of ``fn``'s body, not descending into nested defs,
    lambdas or classes (whose returns are not ``fn``'s)."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        yield node
        if not isinstance(node, (*FunctionNode, ast.Lambda, ast.ClassDef)):
            stack.extend(ast.iter_child_nodes(node))


class ModuleContext:
    def __init__(self, source: str, path: str = "<snippet>"):
        self.source = source
        self.path = rel_path(path)
        self.lines = source.splitlines()
        self.language = language_of(path)
        if self.language == "python":
            self.tree = ast.parse(source, filename=path)
            self.code = source
        else:
            self.tree = None
            self.code = blank_comments(source)

    # ---- findings ---------------------------------------------------
    def finding(self, rule_id: str, node: ast.AST, message: str,
                hint: str = "") -> Finding:
        return self.finding_at(rule_id, getattr(node, "lineno", 1),
                               getattr(node, "col_offset", 0), message, hint)

    def finding_at(self, rule_id: str, line: int, col: int, message: str,
                   hint: str = "") -> Finding:
        text = self.lines[line - 1].strip() if line <= len(self.lines) \
            else ""
        return Finding(rule=rule_id, path=self.path, line=line, col=col,
                       message=message, hint=hint, line_text=text)

    def line_col(self, offset: int):
        """1-based line and 0-based column of a character offset."""
        line = self.source.count("\n", 0, offset) + 1
        return line, offset - (self.source.rfind("\n", 0, offset) + 1)

    # ---- navigation -------------------------------------------------
    def walk(self) -> Iterator[ast.AST]:
        return ast.walk(self.tree) if self.tree is not None else iter(())

    def functions(self) -> Iterator[ast.AST]:
        for node in self.walk():
            if isinstance(node, FunctionNode):
                yield node

    def functions_by_name(self) -> Dict[str, ast.AST]:
        """Every def (module-level AND nested) by bare name — last
        binding wins, which matches how the repo uses local defs."""
        out: Dict[str, ast.AST] = {}
        for fn in self.functions():
            out[fn.name] = fn
        return out

    def path_endswith(self, *suffixes: str) -> bool:
        return any(self.path.endswith(s) for s in suffixes)
