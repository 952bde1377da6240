"""Shared helpers for the contract checkers: tensor-tree comparison and
Finding construction (the JAX package's ``contracts/base.py`` on trees
of tensors instead of avals).

Contract findings ride the same ``Finding``/baseline machinery as the
AST rules, but their identity is not a source line — it is the
*surface key* (``kernel:flash_attention:pallas:cuda:b4_s32_h4kv2_d32``),
stored in ``line_text`` so the ``(rule, path, line_text)`` baseline
identity works unchanged. ``path`` is the registry module that
declared (or should have declared) the contract.

Torch has no weak types, so the JAX package's weak-type branch (and its
``weak_leaves``) has no counterpart: a leaf is its shape and dtype.
"""
from __future__ import annotations

from typing import List

import torch

from repro_torch.analysis.findings import Finding
from repro_torch.interop import tree_map, tree_paths


def contract_finding(rule: str, path: str, surface: str, message: str,
                     hint: str = "") -> Finding:
    return Finding(rule=rule, path=path, line=1, col=0, message=message,
                   hint=hint, line_text=surface)


def aval_str(x) -> str:
    """``float32[4, 32]``: a leaf's dtype and shape."""
    dtype = str(getattr(x, "dtype", "?")).replace("torch.", "")
    return f"{dtype}{list(getattr(x, 'shape', []))}"


def _where(path) -> str:
    return "".join(f"[{k!r}]" for k in path) or "<leaf>"


def leaf_mismatches(expected, got, label: str = "") -> List[str]:
    """Compare two trees of tensors (``interop``'s tree order: dict keys
    sorted, sequences in order): structure, then each leaf's shape and
    dtype. Returns human-readable mismatch strings; [] == pass."""
    prefix = f"{label}: " if label else ""
    e_paths, g_paths = tree_paths(expected), tree_paths(got)
    if [p for p, _ in e_paths] != [p for p, _ in g_paths]:
        return [f"{prefix}tree structure mismatch: expected "
                f"{[_where(p) for p, _ in e_paths]}, got "
                f"{[_where(p) for p, _ in g_paths]}"]
    out = []
    for (path, e), (_, g) in zip(e_paths, g_paths):
        if not isinstance(g, torch.Tensor):
            out.append(f"{prefix}{_where(path)}: expected {aval_str(e)}, "
                       f"got a {type(g).__name__}")
        elif tuple(e.shape) != tuple(g.shape) or e.dtype != g.dtype:
            out.append(f"{prefix}{_where(path)}: expected {aval_str(e)}, "
                       f"got {aval_str(g)}")
    return out


def avals_of(tree):
    """Tree of tensors -> the same tree of ``meta`` tensors of the same
    shapes and dtypes (non-tensor leaves kept as they are)."""
    return tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype,
                                          device="meta")
                    if isinstance(x, torch.Tensor) else x, tree)
