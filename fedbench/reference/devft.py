"""DevFT's stage machinery, plain: the capacity schedule, the split of a
stage's capacity over the layer stacks, DGLG grouping (layer vectors,
cosine similarity, the Laplacian's eigenvectors, seeded k-means), DBLF
fusion of the LoRA stacks and the transfer back (each layer of a group
takes its representative's LoRA).

The similarity is worked out in f64 from the layer vectors' exact
elements; the clustering is the same f64 numpy arithmetic the method
defines, seeded from ``(seed, stage)``.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from fedbench.data import keyed_rng


def capacity_schedule(n_layers: int, n_stages: int, growth: float
                      ) -> List[int]:
    caps = []
    for s in range(1, n_stages + 1):
        c = max(1, -(-n_layers // int(growth ** (n_stages - s))))
        caps.append(min(c, n_layers))
    out = []
    for c in caps:
        if out and c <= out[-1]:
            c = min(out[-1] + 1, n_layers)
        out.append(c)
    out[-1] = n_layers
    return out


def stack_capacities(sizes: Dict[str, int], total_cap: int) -> Dict[str, int]:
    total = sum(sizes.values())
    nonempty = sum(1 for s in sizes.values() if s)
    total_cap = max(min(total_cap, total), nonempty)
    caps = {n: (min(s, max(1, round(total_cap * s / total))) if s else 0)
            for n, s in sizes.items()}
    names = [n for n, s in sorted(sizes.items(), key=lambda kv: -kv[1]) if s]
    i = 0
    while sum(caps.values()) > total_cap:
        n = names[i % len(names)]
        if caps[n] > 1:
            caps[n] -= 1
        i += 1
    i = 0
    while sum(caps.values()) < total_cap:
        n = names[i % len(names)]
        if caps[n] < sizes[n]:
            caps[n] += 1
        i += 1
    return caps


def _sorted_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _sorted_leaves(tree[k])]
    return [tree]


def similarity(stack: dict, lora_stack, max_elems: int = 1 << 20):
    """(L, L) f64 cosine similarity of the layers' vectors: every leaf's
    flat, base then LoRA in sorted-key order, one column kept in every
    ``stride``."""
    leaves = _sorted_leaves(stack)
    if lora_stack is not None:
        leaves += _sorted_leaves(lora_stack)
    n = leaves[0].shape[0]
    flats = [x.reshape(n, -1) for x in leaves]
    d = sum(f.shape[1] for f in flats)
    stride = -(-d // max_elems) if d > max_elems else 1
    parts, offset = [], 0
    for f in flats:
        parts.append(f[:, (-offset % stride)::stride].double())
        offset += f.shape[1]
    v = torch.cat(parts, dim=1)
    v = v / torch.clamp(torch.linalg.vector_norm(v, dim=1, keepdim=True),
                        min=1e-12)
    return torch.clamp(v @ v.T, -1.0, 1.0).cpu().numpy()


def _kmeans(emb, k, seed_words, iters=100):
    rng = keyed_rng(*seed_words, "grouping-kmeans")
    n = emb.shape[0]
    centers = [emb[rng.randint(n)]]
    for _ in range(1, k):
        d2 = np.min([np.sum((emb - c) ** 2, axis=1) for c in centers], axis=0)
        centers.append(emb[rng.choice(n, p=d2 / max(d2.sum(), 1e-12))])
    centers = np.stack(centers)
    labels = np.zeros(n, dtype=np.int64)
    for _ in range(iters):
        dists = np.sum((emb[:, None] - centers[None]) ** 2, axis=2)
        new = np.argmin(dists, axis=1)
        for c in range(k):
            if not np.any(new == c):
                new[np.argmax(np.min(dists, axis=1))] = c
        if np.array_equal(new, labels):
            break
        labels = new
        for c in range(k):
            centers[c] = emb[labels == c].mean(axis=0)
    return labels


def spectral_groups(w: np.ndarray, n_groups: int, seed_words) -> List[List[int]]:
    w = np.array(w, dtype=np.float64)
    L = w.shape[0]
    n_groups = min(n_groups, L)
    if n_groups == L:
        return [[i] for i in range(L)]
    np.fill_diagonal(w, 0.0)
    lap = np.diag(w.sum(axis=1)) - w
    _, vecs = np.linalg.eigh(lap)
    emb = vecs[:, :n_groups]
    emb = emb / np.clip(np.linalg.norm(emb, axis=1, keepdims=True), 1e-12, None)
    labels = _kmeans(emb, n_groups, seed_words)
    groups = [sorted(np.nonzero(labels == c)[0].tolist())
              for c in range(n_groups)]
    groups.sort(key=lambda g: g[0])
    return groups


def eigen_gap(w: np.ndarray, n_groups: int) -> float:
    """The gap between the Laplacian's eigenvalues ``n_groups - 1`` and
    ``n_groups`` (what decides the embedding the clustering sees)."""
    w = np.array(w, dtype=np.float64)
    if n_groups >= w.shape[0]:
        return float("inf")
    np.fill_diagonal(w, 0.0)
    ev = np.linalg.eigvalsh(np.diag(w.sum(axis=1)) - w)
    return float(ev[n_groups] - ev[n_groups - 1])


def stage_groups(blocks: dict, lora: dict, capacity: int, seed: int,
                 stage: int):
    """{stack: groups} of the stage submodel, and {stack: eigen-gap} of
    each stack it cuts."""
    sizes = {n: _sorted_leaves(s)[0].shape[0] for n, s in blocks.items()}
    caps = stack_capacities(sizes, capacity)
    groups, gaps = {}, {}
    for name, stack in blocks.items():
        if caps[name] >= sizes[name]:
            groups[name] = [[i] for i in range(sizes[name])]
            continue
        w = similarity(stack, lora.get(name))
        groups[name] = spectral_groups(w, caps[name], (seed, stage))
        gaps[name] = eigen_gap(w, caps[name])
    return groups, gaps


def fuse_lora(lora: dict, groups: Dict[str, List[List[int]]],
              beta: float) -> dict:
    """The submodel's LoRA: each group's DBLF fusion of its layers' LoRA."""
    def fuse(leaf, gs):
        out = []
        for g in gs:
            a = leaf[g[0]].float()
            if len(g) > 1:
                s = torch.zeros_like(a)
                for j in g:
                    s += leaf[j].float()
                a = a + beta * (s - len(g) * a)
            out.append(a)
        return torch.stack(out)
    return {name: _tmap(lambda t, gs=groups[name]: fuse(t, gs), st)
            for name, st in lora.items()}


def broadcast(sub_lora: dict, groups: Dict[str, List[List[int]]]) -> dict:
    """The global LoRA after a stage: layer j of group g takes the
    trained LoRA of the submodel's layer g."""
    out = {}
    for name, st in sub_lora.items():
        n = sum(len(g) for g in groups[name])
        labels = np.zeros(n, dtype=np.int64)
        for gi, g in enumerate(groups[name]):
            labels[g] = gi
        idx = torch.from_numpy(labels)
        out[name] = _tmap(lambda t: t[idx.to(t.device)], st)
    return out


def _tmap(fn, tree):
    if isinstance(tree, dict):
        return {k: _tmap(fn, v) for k, v in tree.items()}
    return fn(tree)
