"""Deconfliction-guided layer grouping (DGLG) — paper §3.2 (the JAX
package's ``repro.core.grouping``).

Pipeline (Eq. 1–3): per-layer parameter vectors → cosine similarity matrix
W → graph Laplacian L = D − W → eigenvectors of the L_s smallest
eigenvalues → k-means on the spectral embedding → L_s groups.

Ablation variants (paper Table 2): RANDOM and EVEN grouping.

The layer vectors and W are tensors on the stack's device; the spectral
clustering is the JAX package's numpy code, kept line for line, so a W
that agrees gives the same groups. All functions operate on a *layer
stack*: a nested dict whose leaves have a leading layer axis.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.data.synthetic import keyed_rng, seed_entropy
from repro_torch.interop import tree_leaves

# ---------------------------------------------------------------------------
# Layer vectors + similarity (Eq. 1)
# ---------------------------------------------------------------------------


def layer_vectors(stack: dict, lora_stack: Optional[dict] = None,
                  max_elems: int = 1 << 20) -> torch.Tensor:
    """Flatten each layer of a stack into a vector (L, D) float32.

    Includes the layer's LoRA parameters when given (Eq. 1: "including
    their corresponding LoRA parameters"). For very wide layers a
    deterministic stride subsample caps D at ``max_elems``.

    The vector is the JAX package's: the leaves' flats in
    ``tree_leaves`` order, concatenated, every ``stride``-th column kept.
    The concatenation is never built: each leaf gives the kept columns
    that fall inside it, so a full-width MoE stack (24 layers of ~54 M
    elements) costs the subsample's memory, not 5 GB of f32 flats.
    """
    leaves = list(tree_leaves(stack))
    if lora_stack is not None:
        leaves += list(tree_leaves(lora_stack))
    n = leaves[0].shape[0]
    flats = [x.reshape(n, -1) for x in leaves]
    d = sum(f.shape[1] for f in flats)
    stride = -(-d // max_elems) if d > max_elems else 1
    parts, offset = [], 0
    for f in flats:
        first = -offset % stride      # first kept global column in the leaf
        parts.append(f[:, first::stride].float())
        offset += f.shape[1]
    return torch.cat(parts, dim=1)


def similarity_matrix(vecs: torch.Tensor) -> torch.Tensor:
    """Cosine similarity (Eq. 1). vecs: (L, D) -> (L, L) float32."""
    norms = torch.linalg.vector_norm(vecs, dim=1, keepdim=True)
    vn = vecs / torch.clamp(norms, min=1e-12)
    w = vn @ vn.T
    return torch.clamp(w, -1.0, 1.0)


# ---------------------------------------------------------------------------
# Spectral clustering (Eq. 2–3)
# ---------------------------------------------------------------------------


def _kmeans(emb: np.ndarray, k: int, seed, iters: int = 100) -> np.ndarray:
    """Deterministic k-means++ on (L, k) spectral embedding. ``seed`` is
    an int or a tuple of keyed entropy (see ``keyed_rng``)."""
    rng = keyed_rng(*seed_entropy(seed), "grouping-kmeans")
    n = emb.shape[0]
    # k-means++ init
    centers = [emb[rng.randint(n)]]
    for _ in range(1, k):
        d2 = np.min(
            [np.sum((emb - c) ** 2, axis=1) for c in centers], axis=0)
        probs = d2 / max(d2.sum(), 1e-12)
        centers.append(emb[rng.choice(n, p=probs)])
    centers = np.stack(centers)
    labels = np.zeros(n, dtype=np.int64)
    for _ in range(iters):
        dists = np.sum((emb[:, None] - centers[None]) ** 2, axis=2)
        new_labels = np.argmin(dists, axis=1)
        # keep clusters non-empty: reassign the farthest point to any empty one
        for c in range(k):
            if not np.any(new_labels == c):
                far = np.argmax(np.min(dists, axis=1))
                new_labels[far] = c
        if np.array_equal(new_labels, labels):
            break
        labels = new_labels
        for c in range(k):
            centers[c] = emb[labels == c].mean(axis=0)
    return labels


def spectral_grouping(w, n_groups: int, seed=0) -> List[List[int]]:
    """Partition L layers into ``n_groups`` groups (Eq. 2–3). ``w`` is a
    tensor or an array; the clustering runs in float64 numpy.

    Returns groups as lists of layer indices, each sorted ascending,
    ordered by their anchor (minimum) index — the order in which the
    representative layers are concatenated into the submodel.
    """
    if isinstance(w, torch.Tensor):
        w = w.detach().cpu().numpy()
    w = np.asarray(w, dtype=np.float64)
    L = w.shape[0]
    n_groups = min(n_groups, L)
    if n_groups == L:
        return [[i] for i in range(L)]
    np.fill_diagonal(w, 0.0)
    d = np.diag(w.sum(axis=1))
    lap = d - w
    eigvals, eigvecs = np.linalg.eigh(lap)          # ascending
    emb = eigvecs[:, :n_groups]                     # (L, L_s)
    # row-normalize (standard spectral clustering stabilization)
    nrm = np.linalg.norm(emb, axis=1, keepdims=True)
    emb = emb / np.clip(nrm, 1e-12, None)
    labels = _kmeans(emb, n_groups, seed)
    groups = [sorted(np.nonzero(labels == c)[0].tolist())
              for c in range(n_groups)]
    groups.sort(key=lambda g: g[0])
    return groups


# ---------------------------------------------------------------------------
# Ablation variants (Table 2)
# ---------------------------------------------------------------------------


def random_grouping(n_layers: int, n_groups: int, seed=0
                    ) -> List[List[int]]:
    rng = keyed_rng(*seed_entropy(seed), "grouping-random")
    n_groups = min(n_groups, n_layers)
    perm = rng.permutation(n_layers)
    groups = [sorted(perm[i::n_groups].tolist()) for i in range(n_groups)]
    groups.sort(key=lambda g: g[0])
    return groups


def even_grouping(n_layers: int, n_groups: int) -> List[List[int]]:
    """Contiguous equal-size blocks."""
    n_groups = min(n_groups, n_layers)
    bounds = np.linspace(0, n_layers, n_groups + 1).round().astype(int)
    return [list(range(bounds[i], bounds[i + 1])) for i in range(n_groups)]


def make_groups(method: str, stack: dict, lora_stack, n_groups: int,
                seed=0) -> List[List[int]]:
    L = tree_leaves(stack)[0].shape[0]
    if method == "dglg":
        w = similarity_matrix(layer_vectors(stack, lora_stack))
        return spectral_grouping(w, n_groups, seed)
    if method == "random":
        return random_grouping(L, n_groups, seed)
    if method == "even":
        return even_grouping(L, n_groups)
    raise ValueError(f"unknown grouping method {method!r}")


def labels_from_groups(groups: Sequence[Sequence[int]], n_layers: int
                       ) -> np.ndarray:
    labels = np.zeros(n_layers, dtype=np.int64)
    for gi, g in enumerate(groups):
        for j in g:
            labels[j] = gi
    return labels
