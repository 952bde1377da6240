"""Moving weights between the two packages: nested dicts of numpy arrays
to nested dicts of tensors and back (params, LoRA trees, adapter stacks,
the decode cache ``{"stacks": ..., "pos": ...}``).

numpy only on this side — no JAX, no ``ml_dtypes``. The key structure
is kept exactly; ``tree_leaves`` lists leaves in sorted-key order, the
order ``jax.tree.leaves`` uses for dicts. int32, float32 and bfloat16
cross bit-exactly: a bf16 numpy array (dtype name ``"bfloat16"``, as
JAX hands them out) travels as its uint16 bit pattern and is viewed as
``torch.bfloat16``.
"""
from __future__ import annotations

from typing import Any, List

import numpy as np
import torch


def _to_tensor(arr: np.ndarray, device) -> torch.Tensor:
    # a copy: the tensor owns its memory (JAX hands out read-only
    # buffers, and the decode cache is written in place)
    arr = np.array(arr, copy=True, order="C")
    if arr.dtype.name == "bfloat16":
        bits = torch.from_numpy(arr.view(np.uint16))
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def _bf16_numpy_dtype():
    """numpy's bfloat16 dtype when some library (``ml_dtypes``, which
    JAX loads) has registered one, else None."""
    try:
        return np.dtype("bfloat16")
    except TypeError:
        return None


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        bf16 = _bf16_numpy_dtype()
        if bf16 is None:
            return t.float().numpy()     # exact: bf16 values are f32 values
        return t.view(torch.uint16).numpy().view(bf16)
    return t.numpy()


def from_numpy_tree(tree: Any, device="cpu") -> Any:
    """Nested dict (or list/tuple) of numpy arrays -> the same structure
    of tensors on ``device``. Other leaves (Python scalars such as a
    LoRA ``alpha``) pass through unchanged."""
    if isinstance(tree, dict):
        return {k: from_numpy_tree(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(from_numpy_tree(v, device) for v in tree)
    if isinstance(tree, (np.ndarray, np.generic)):
        return _to_tensor(np.asarray(tree), device)
    return tree


def to_numpy_tree(tree: Any) -> Any:
    """Inverse of ``from_numpy_tree``: tensors -> numpy arrays (host)."""
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy_tree(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return _to_numpy(tree)
    return tree


def tree_leaves(tree: Any) -> List[Any]:
    """Leaves in ``jax.tree.leaves`` order: dict keys sorted, sequences
    in order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_paths(tree: Any, prefix=()) -> List[tuple]:
    """``(key path, leaf)`` pairs in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in tree_paths(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree)
                for pl in tree_paths(v, prefix + (i,))]
    return [(prefix, tree)]


def tree_map(fn, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leaf-wise over trees of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *vs) for vs in zip(tree, *rest))
    return fn(tree, *rest)
