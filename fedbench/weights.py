"""Seeded base weights and initial LoRA, made on the device.

The program's ``init_params``/``init_lora`` run on the ``meta`` device and
give only the trees' layout (names, shapes, dtypes). Every leaf is then a
view into one flat buffer per dtype, filled here from a ``torch.Generator``
on the device: one normal draw over each buffer, one more draw a leaf for
each level of kinship, then the rules of the configuration file
(``init``, ``lora_init``: the first rule whose pattern matches the leaf's
dotted path sets it).

Kinship: pretrained models hold groups of similar adjacent layers, which
DevFT's grouping is built to find (its premise of functional
homogeneity). Independent random layers are all alike, so the grouping
would rest on ties. A configuration's ``layer_kinship`` lists weights
w_1..w_n: layer i of a stack is ``sqrt(1 - sum w) z_i + sum_l sqrt(w_l)
z_l[i >> l]``, each z a standard normal draw, so layers sharing a block of
2, 4, 8, ... layers share that part (their cosine similarity is the sum of
the weights of the levels they share).
"""
from __future__ import annotations

import math
import re

import numpy as np
import torch

ALIGN = 64          # elements between leaf starts (128 bytes in bf16)


def leaf_paths(tree, prefix=()):
    """``(dotted path, leaf)`` pairs in sorted-key order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in leaf_paths(tree[k], prefix + (str(k),))]
    return [(".".join(prefix), tree)]


def _set(tree, path, value):
    keys = path.split(".")
    for k in keys[:-1]:
        tree = tree.setdefault(k, {})
    tree[keys[-1]] = value


def _rule(rules, path):
    for pattern, spec in rules:
        if re.search(pattern, path):
            return spec
    raise ValueError(f"no init rule matches leaf {path!r}")


def generator(seed: int, label: str, device) -> torch.Generator:
    word = np.random.SeedSequence(
        (int(seed), int.from_bytes(label.encode(), "big"))).generate_state(
            1, dtype=np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(word))


def _flat_views(specs, device):
    """Real leaves for a meta tree: views into one flat buffer per dtype,
    every leaf starting at a multiple of ``ALIGN`` elements."""
    paths = leaf_paths(specs)
    offsets, totals = {}, {}
    for path, t in paths:
        off = totals.get(t.dtype, 0)
        offsets[path] = off
        totals[t.dtype] = off + -(-t.numel() // ALIGN) * ALIGN
    flats = {dt: torch.empty(n, dtype=dt, device=device)
             for dt, n in totals.items()}
    leaves = {}
    for path, t in paths:
        off = offsets[path]
        leaves[path] = flats[t.dtype][off:off + t.numel()].view(t.shape)
    return flats, leaves


def fill(specs, rules, gen: torch.Generator, device, kinship=(),
         stack_prefix: str = "blocks.") -> dict:
    """A real tree shaped like the meta tree ``specs``, filled by
    ``rules``; leaves under ``stack_prefix`` with a normal rule get the
    kinship levels along their leading (layer) axis."""
    flats, leaves = _flat_views(specs, device)
    for dt in sorted(flats, key=str):
        flats[dt].normal_(generator=gen)
    own = math.sqrt(max(0.0, 1.0 - sum(kinship)))
    out = {}
    for path, leaf in sorted(leaves.items()):
        spec = _rule(rules, path)
        if "const" in spec:
            leaf.fill_(float(spec["const"]))
        elif "log_linspace" in spec:
            lo, hi = spec["log_linspace"]
            n = leaf.shape[-1]
            leaf.copy_(torch.log(torch.linspace(lo, hi, n, dtype=torch.float32,
                                                device=leaf.device))
                       .expand(leaf.shape))
        else:
            std = spec["normal"]
            if std == "fan_in":
                std = 1.0 / math.sqrt(leaf.shape[-2])
            if path.startswith(stack_prefix) and kinship:
                n = leaf.shape[0]
                rows = leaf.view(n, -1)
                rows.mul_(own)
                for lvl, w in enumerate(kinship, start=1):
                    blocks = ((n - 1) >> lvl) + 1
                    z = torch.randn((blocks, rows.shape[1]), generator=gen,
                                    dtype=leaf.dtype, device=leaf.device)
                    for i in range(n):
                        rows[i].add_(z[i >> lvl], alpha=math.sqrt(w))
                    del z
            leaf.mul_(std)
        _set(out, path, leaf)
    return out


def make(cfg, cfg_doc: dict, seed: int, device, phases=None):
    """(params, lora) for the port's ``ModelConfig`` ``cfg`` as the
    configuration file ``cfg_doc`` states them; ``phases`` gets the
    seconds of the layout (meta trees) and of the fill."""
    import time

    from repro_torch.launch.specs import lora_specs, param_specs

    t = time.perf_counter()
    dtype = getattr(torch, cfg_doc["model"]["dtype"])
    lo = cfg_doc["lora"]
    pspec = param_specs(cfg, dtype)
    lspec = lora_specs(cfg, rank=lo["rank"])
    if phases is not None:
        phases["weights_layout_s"] = time.perf_counter() - t
    params = fill(pspec, cfg_doc["init"], generator(seed, "params", device),
                  device, kinship=cfg_doc.get("layer_kinship", ()))
    lora = fill(lspec, cfg_doc["lora_init"], generator(seed, "lora", device),
                device, stack_prefix="\0")
    return params, lora
