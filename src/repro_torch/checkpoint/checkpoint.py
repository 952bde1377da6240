"""Tree checkpointing in the JAX package's ``.ckpt`` format (its
``repro.checkpoint``), with no msgpack dependency.

A checkpoint is one msgpack map ``{"treedef", "leaves", "paths"}``:
``treedef`` is the text ``str(jax.tree.structure(tree))`` gives,
``leaves`` holds one ``{"d": dtype name, "s": shape, "b": raw bytes}``
map per leaf in sorted-key order (bfloat16 as its uint16 bits), and
``paths`` the leaves' ``jax.tree_util.keystr`` key paths. This module
carries its own encoder and decoder for the part of msgpack that
payload uses (maps, arrays, str, non-negative int, bin; each in its
smallest form, as ``msgpack.packb(..., use_bin_type=True)`` chooses),
so a file it writes is byte-identical to the JAX package's for the same
tree, and each package restores the other's. Writes are atomic (tmp +
rename) so a crashed run never leaves a torn checkpoint.
"""
from __future__ import annotations

import os
import struct
import tempfile
from typing import Any, List

import numpy as np
import torch

from repro_torch.interop import tree_leaves, tree_paths

_BF16 = "bfloat16"


# ---------------------------------------------------------------------------
# the msgpack subset
# ---------------------------------------------------------------------------

def _head(n: int, fix: int, fix_max: int, wide) -> bytes:
    """Length header: the fix form up to ``fix_max``, else the first of
    ``wide`` ((tag, max, struct format), smallest first) that holds n."""
    if fix is not None and n <= fix_max:
        return bytes([fix | n])
    for tag, top, fmt in wide:
        if n <= top:
            return bytes([tag]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack object of length {n} is too long")


_U8, _U16, _U32 = 0xFF, 0xFFFF, 0xFFFFFFFF


def _pack(obj, out: List[bytes]) -> None:
    if isinstance(obj, dict):
        out.append(_head(len(obj), 0x80, 15,
                         ((0xDE, _U16, ">H"), (0xDF, _U32, ">I"))))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, (list, tuple)):
        out.append(_head(len(obj), 0x90, 15,
                         ((0xDC, _U16, ">H"), (0xDD, _U32, ">I"))))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        out.append(_head(len(raw), 0xA0, 31,
                         ((0xD9, _U8, ">B"), (0xDA, _U16, ">H"),
                          (0xDB, _U32, ">I"))))
        out.append(raw)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        out.append(_head(len(raw), None, -1,
                         ((0xC4, _U8, ">B"), (0xC5, _U16, ">H"),
                          (0xC6, _U32, ">I"))))
        out.append(raw)
    elif isinstance(obj, int) and not isinstance(obj, bool) and obj >= 0:
        out.append(_head(obj, 0x00, 0x7F,
                         ((0xCC, _U8, ">B"), (0xCD, _U16, ">H"),
                          (0xCE, _U32, ">I"),
                          (0xCF, 0xFFFFFFFFFFFFFFFF, ">Q"))))
    else:
        raise TypeError(f"checkpoint payload cannot hold {type(obj)}")


def packb(obj) -> bytes:
    """msgpack bytes of ``obj`` (dict, list, tuple, str, bytes,
    non-negative int)."""
    out: List[bytes] = []
    _pack(obj, out)
    return b"".join(out)


#: tag -> (kind, struct format of its length or value)
_WIDE = {0xDE: ("map", ">H"), 0xDF: ("map", ">I"),
         0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
         0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
         0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
         0xCC: ("int", ">B"), 0xCD: ("int", ">H"), 0xCE: ("int", ">I"),
         0xCF: ("int", ">Q")}


def _unpack(buf: memoryview, i: int):
    """(object, next offset) of the msgpack object at ``buf[i]``."""
    tag = buf[i]
    i += 1
    if tag <= 0x7F:
        return tag, i
    if 0x80 <= tag <= 0x8F:
        kind, n = "map", tag & 0x0F
    elif 0x90 <= tag <= 0x9F:
        kind, n = "array", tag & 0x0F
    elif 0xA0 <= tag <= 0xBF:
        kind, n = "str", tag & 0x1F
    elif tag in _WIDE:
        kind, fmt = _WIDE[tag]
        size = struct.calcsize(fmt)
        (n,) = struct.unpack(fmt, buf[i:i + size])
        i += size
    else:
        raise ValueError(f"unsupported msgpack tag {tag:#04x} at byte "
                         f"{i - 1}")
    if kind == "int":
        return n, i
    if kind in ("str", "bin"):
        raw = bytes(buf[i:i + n])
        return (raw.decode("utf-8") if kind == "str" else raw), i + n
    if kind == "array":
        out = []
        for _ in range(n):
            v, i = _unpack(buf, i)
            out.append(v)
        return out, i
    obj = {}
    for _ in range(n):
        k, i = _unpack(buf, i)
        obj[k], i = _unpack(buf, i)
    return obj, i


def unpackb(data: bytes):
    obj, end = _unpack(memoryview(data), 0)
    if end != len(data):
        raise ValueError(f"{len(data) - end} trailing bytes after the "
                         f"msgpack object")
    return obj


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------

def _treedef(tree) -> str:
    """``str(jax.tree.structure(tree))`` for nested dicts, lists and
    tuples of array leaves (dict keys sorted, as JAX flattens them)."""
    def spec(t) -> str:
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {spec(t[k])}"
                                   for k in sorted(t)) + "}"
        if isinstance(t, list):
            return "[" + ", ".join(spec(v) for v in t) + "]"
        if isinstance(t, tuple):
            inner = ", ".join(spec(v) for v in t)
            return f"({inner},)" if len(t) == 1 else f"({inner})"
        return "*"
    return f"PyTreeDef({spec(tree)})"


def _keystr(path) -> str:
    return "".join(f"[{k!r}]" for k in path)


def _pack_leaf(x) -> dict:
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return {"d": _BF16, "s": list(t.shape),
                    "b": t.view(torch.uint16).numpy().tobytes()}
        arr = t.numpy()
    else:
        arr = np.asarray(x)
        if arr.dtype.hasobject:
            raise TypeError(f"checkpoint leaves are arrays, got {type(x)}")
    return {"d": str(arr.dtype), "s": list(arr.shape), "b": arr.tobytes()}


def _unpack_leaf(obj: dict, device) -> torch.Tensor:
    if obj["d"] == _BF16:
        flat = np.frombuffer(obj["b"], dtype=np.uint16).copy()
        t = torch.from_numpy(flat).view(torch.bfloat16)
    else:
        flat = np.frombuffer(obj["b"], dtype=np.dtype(obj["d"])).copy()
        t = torch.from_numpy(flat)
    return t.reshape(obj["s"]).to(device)


def _unflatten(template, leaves):
    """``template``'s structure with its leaves taken from the iterator
    ``leaves`` in ``tree_leaves`` order."""
    if isinstance(template, dict):
        done = {k: _unflatten(template[k], leaves) for k in sorted(template)}
        return {k: done[k] for k in template}
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(v, leaves) for v in template)
    return next(leaves)


def save(path: str, tree: Any) -> None:
    """Write ``tree`` (nested dicts/lists of tensors or arrays) to
    ``path``; tensors on the card are copied to the host first."""
    payload = {
        "treedef": _treedef(tree),
        "leaves": [_pack_leaf(l) for l in tree_leaves(tree)],
        "paths": [_keystr(p) for p, _ in tree_paths(tree)],
    }
    data = packb(payload)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(os.path.abspath(path)))
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def restore(path: str, template: Any) -> Any:
    """Restore into the structure of ``template`` (leaf count and shapes
    checked; each tensor lands on its template leaf's device and keeps
    the checkpoint's dtype)."""
    with open(path, "rb") as f:
        payload = unpackb(f.read())
    t_leaves = tree_leaves(template)
    if len(t_leaves) != len(payload["leaves"]):
        raise ValueError(
            f"checkpoint has {len(payload['leaves'])} leaves, template "
            f"expects {len(t_leaves)}")
    for i, (obj, t) in enumerate(zip(payload["leaves"], t_leaves)):
        if tuple(obj["s"]) != tuple(np.shape(t)):
            raise ValueError(
                f"leaf {payload['paths'][i]}: checkpoint shape "
                f"{tuple(obj['s'])} != template {tuple(np.shape(t))}")
    leaves = [_unpack_leaf(obj, t.device if isinstance(t, torch.Tensor)
                           else "cpu")
              for obj, t in zip(payload["leaves"], t_leaves)]
    return _unflatten(template, iter(leaves))
