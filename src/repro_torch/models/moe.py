"""Top-k mixture-of-experts with capacity-based gather/scatter dispatch
(the JAX package's ``repro.models.moe``, its ``moe_block`` path).

Tokens are gathered into per-expert capacity buffers by index
arithmetic (no one-hot dispatch product), run through the batched expert
SwiGLU — the ``moe_expert_ffn`` kernel on the card — and combined back
weighted by the router. Routing, capacity, positions and the keep mask
are integer bookkeeping and equal the JAX package's exactly.

Determinism on the card: JAX scatters with ``.at[].add``; here

* the gather *assigns* each kept slot's token to its unique (expert,
  position) row; dropped slots all write zeros to one spare row, so
  duplicate indices only ever write equal values;
* the combine reduces a (T, k, d) tensor over k, adding the k
  contributions in slot order in the activation dtype, as XLA's
  scatter-add on the CPU does.

Neither depends on the order of concurrent writes, so a run gives the
same bits every time (the backward of the combine's gather adds only
exact zeros into rows that another slot owns).

Used by granite-moe, jamba (its ``mamba_moe`` blocks) and deepseek-v3
(its ``mla_moe`` blocks: 256 routed experts, top 8, plus the shared
expert, a SwiGLU MLP of ``d_ff_expert * n_shared_experts`` that every
token passes through), in training, prefill and decoding; at decode
``moe_block`` runs on the (B, d) tokens of one step, so the expert FFN
sees capacity buffers of 8 rows (the floor of ``_capacity``).
``moe_block_ep`` (the JAX package's expert-parallel shard_map path)
needs several devices and is not ported (ROADMAP.md).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import dispatch, ops, ref
from repro_torch.models.layers import _randn, init_mlp, mlp, model_backend

#: the plain version of the expert FFN (the kernel's ``reference``)
expert_ffn_reference = ref.moe_expert_ffn_ref


def init_moe(gen: torch.Generator, cfg, dtype, lead=()) -> dict:
    """Router (f32) and expert weights; ``lead`` prepends stack axes."""
    m = cfg.moe
    d, e, ff = cfg.d_model, m.n_experts, m.d_ff_expert
    si, so = 1.0 / math.sqrt(d), 1.0 / math.sqrt(ff)
    p = {
        "router": _randn(gen, (*lead, d, e), torch.float32, si),
        "wg": _randn(gen, (*lead, e, d, ff), dtype, si),
        "wu": _randn(gen, (*lead, e, d, ff), dtype, si),
        "wd": _randn(gen, (*lead, e, ff, d), dtype, so),
    }
    if m.n_shared_experts:
        p["shared"] = init_mlp(gen, d, ff * m.n_shared_experts, dtype,
                               lead=lead)
    return p


def router_topk(params, cfg, x):
    """Returns (weights (T,k), experts (T,k) int64, aux_loss scalar).

    The top k by a stable descending sort: among equal probabilities the
    lower expert index comes first, as in ``jax.lax.top_k``."""
    m = cfg.moe
    t = x.shape[0]
    logits = x.float() @ params["router"]                         # (T,E)
    probs = torch.softmax(logits, dim=-1)
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, idx = w[:, :m.top_k], idx[:, :m.top_k]
    w = w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-9)
    # Switch-style load-balance auxiliary loss
    me = probs.mean(dim=0)                                        # (E,)
    ce = _one_hot(idx.reshape(-1), m.n_experts).sum(dim=0).float() \
        / (t * m.top_k)
    aux = m.n_experts * torch.sum(me * ce) * m.router_aux_coef
    return w, idx, aux


def _capacity(cfg, n_tokens: int) -> int:
    """Slots per expert: rounded up to 8, at least 8 (the JAX package's
    rule; it decides which slots drop)."""
    m = cfg.moe
    c = int(math.ceil(n_tokens * m.top_k / m.n_experts * m.capacity_factor))
    return max(8, -(-c // 8) * 8)


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """(S,) -> (S, n) int32 by comparison (``one_hot`` checks its input's
    range on the host, a device sync per call)."""
    return (idx[:, None] == torch.arange(n, device=idx.device)).int()


def _dispatch_indices(idx: torch.Tensor, n_experts: int, capacity: int):
    """slot -> (expert, position-in-expert) with capacity dropping.

    idx: (T*k,) expert id per slot, slots in token-major order. Returns
    (pos (T*k,), keep (T*k,) bool, fill (E,) int32): a slot's position
    counts the earlier slots routed to the same expert; ``fill[e]`` is
    how many rows of expert e's buffer the kept slots take, min(count,
    capacity), rows 0..fill-1. The count is a scan along the slot axis of
    the transposed (E, T*k) one-hot, which the card runs as one row per
    expert (the (T*k, E) layout's scan over the outer axis took ~6 ms per
    layer at the training path's shape); its last column is each
    expert's count, so the fill costs no host sync."""
    counts = _one_hot(idx, n_experts).T.contiguous().cumsum(dim=1) - 1
    pos = counts.gather(0, idx[None, :])[0].long()
    keep = pos < capacity
    fill = torch.clamp(counts[:, -1] + 1, max=capacity).int()
    return pos, keep, fill


def moe_block(params: dict, cfg, x: torch.Tensor, *,
              capacity: Optional[int] = None):
    """x: (T, d) flattened tokens -> (y (T, d), aux_loss)."""
    m = cfg.moe
    t, d = x.shape
    e, k = m.n_experts, m.top_k
    cap = capacity or _capacity(cfg, t)
    w, idx, aux = router_topk(params, cfg, x)                     # (T,k)
    flat_idx = idx.reshape(-1)                                    # (T*k,)
    pos, keep, fill = _dispatch_indices(flat_idx, e, cap)
    # gather tokens into (E, C, d) buffers: kept slots own their row;
    # dropped slots write zeros to the spare row E*C. Slot s holds token
    # s // k: an expand, whose backward is a sum over k (an index's
    # backward would be a sort-based scatter)
    rows = torch.where(keep, flat_idx * cap + pos,
                       torch.full_like(pos, e * cap))
    tokens = x[:, None, :].expand(t, k, d).reshape(t * k, d)
    vals = torch.where(keep[:, None], tokens, 0)
    flat = x.new_zeros((e * cap + 1, d)).index_put((rows,), vals)
    buf = flat[:e * cap].reshape(e, cap, d)
    # expert e's rows past fill[e] are zero: the kernel skips their tiles
    backend = model_backend(cfg)
    if dispatch.use_kernel(backend, x.device):
        out = ops.moe_expert_ffn(buf, params["wg"], params["wu"],
                                 params["wd"], fill=fill, backend=backend)
    else:
        out = expert_ffn_reference(buf, params["wg"], params["wu"],
                                   params["wd"], fill=fill)
    # combine back: the k contributions of each token, in slot order.
    # index_select's backward adds into unique rows but for the dropped
    # slots' zeros, so its result does not depend on the order of adds
    safe = torch.where(keep, flat_idx * cap + pos, torch.zeros_like(pos))
    gathered = torch.where(keep[:, None], torch.index_select(
        out.reshape(e * cap, d), 0, safe), 0)
    scale = w.reshape(-1)[:, None].to(x.dtype)
    contrib = (gathered * scale).reshape(t, k, d)
    y = contrib[:, 0]
    for j in range(1, k):
        y = y + contrib[:, j]
    if "shared" in params:
        y = y + mlp(params["shared"], x[None])[0]
    return y, aux
