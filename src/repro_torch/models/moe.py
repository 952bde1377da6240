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

The registry configs keep the JAX package's rules: a softmax router
with a Switch loss, every routed expert held, slots dropped past a
capacity of 1.25x (granite and jamba run them; deepseek-v3-671b's
registry config too). ``MoEConfig``'s own fields switch on DeepSeek-V3's
published ones (the benchmark's ``deepseek-v3-8l`` sets them):
``scoring="sigmoid"`` with ``n_group``/``topk_group`` and
``routed_scale`` (the grouped sigmoid router and its frozen
``e_score_correction_bias``, the sequence-wise balance loss over
``moe_block``'s ``batch_shape``, and a buffer row for every token, so
no slot drops) and ``n_routed`` / ``first_expert`` (an expert share:
the router over all ``n_routed`` experts, this layer holding
``n_experts`` of them, the positions counted over the held experts
alone). With the defaults the softmax
path's bits are the JAX package's, as before.

``moe_block_ep`` is the JAX package's expert-parallel ``shard_map`` path
on a ``DeviceMesh``: each rank of the ``model`` axis runs the experts it
owns on the tokens it holds (its shard of the data axes, the same on
every ``model`` rank) and the outputs are summed over the ``model``
group. It keeps the rules above.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.analysis.tracing import count_moe, span
from repro_torch.kernels import dispatch, ops, ref
from repro_torch.kernels.common import NEG_INF
from repro_torch.models.layers import _randn, init_mlp, mlp, model_backend

#: the plain version of the expert FFN (the kernel's ``reference``)
expert_ffn_reference = ref.moe_expert_ffn_ref


def init_moe(gen: torch.Generator, cfg, dtype, lead=()) -> dict:
    """Router (f32, over all ``router_width`` experts) and the weights of
    the ``n_experts`` experts held here; ``lead`` prepends stack axes.
    The sigmoid router adds ``e_score_correction_bias`` (f32, one a
    routed expert, zeros here: a base weight the configuration's
    initialiser sets), which only selection reads; it is frozen and
    gets no adapter, as every base weight."""
    m = cfg.moe
    d, e, ff = cfg.d_model, m.n_experts, m.d_ff_expert
    si, so = 1.0 / math.sqrt(d), 1.0 / math.sqrt(ff)
    p = {
        "router": _randn(gen, (*lead, d, m.router_width), torch.float32, si),
        "wg": _randn(gen, (*lead, e, d, ff), dtype, si),
        "wu": _randn(gen, (*lead, e, d, ff), dtype, si),
        "wd": _randn(gen, (*lead, e, ff, d), dtype, so),
    }
    if m.scoring == "sigmoid":
        p["e_score_correction_bias"] = torch.zeros(
            (*lead, m.router_width), dtype=torch.float32, device=gen.device)
    if m.n_shared_experts:
        p["shared"] = init_mlp(gen, d, ff * m.n_shared_experts, dtype,
                               lead=lead)
    return p


def router_topk(params, cfg, x, batch_shape=None):
    """Returns (weights (T,k), experts (T,k) int64, aux_loss scalar).

    ``softmax`` scoring: the top k probabilities by a stable descending
    sort (among equal probabilities the lower expert index first, as in
    ``jax.lax.top_k``), normalised to sum 1. ``sigmoid`` scoring
    (DeepSeek-V3's ``noaux_tc``): scores sigmoid(x W_r); selection on the
    scores plus ``e_score_correction_bias``, inside the ``topk_group`` of
    ``n_group`` groups whose 2 best biased scores sum highest (ties to the
    lower index, groups and experts alike); weights the chosen experts'
    unbiased scores, normalised to sum 1, times ``routed_scale``.
    Experts are indices over all ``router_width``.

    The aux loss: with softmax scoring the Switch loss (E Σ_e mean
    prob_e · share of slots_e, the JAX package's), with sigmoid scoring
    DeepSeek-V3's sequence-wise balance loss (arXiv:2412.19437
    eq. 17-20: per sequence of ``batch_shape`` (B, S),
    Σ_e f_e P_e with f_e = N/(k S) · the sequence's slots on e and P_e
    the mean over its tokens of the scores normalised to sum 1; the mean
    over sequences), times ``router_aux_coef``."""
    m = cfg.moe
    t, n, k = x.shape[0], m.router_width, m.top_k
    logits = x.float() @ params["router"]                         # (T,N)
    if m.scoring == "sigmoid":
        scores = torch.sigmoid(logits)
        choice = scores + params["e_score_correction_bias"]
        if m.n_group > 1:
            groups = choice.reshape(t, m.n_group, n // m.n_group)
            rank = torch.topk(groups, 2, dim=-1).values.sum(dim=-1)
            _, best = torch.sort(rank, dim=-1, descending=True, stable=True)
            kept = torch.zeros_like(rank, dtype=torch.bool).scatter(
                1, best[:, :m.topk_group], True)
            choice = choice.masked_fill(
                ~kept.repeat_interleave(n // m.n_group, dim=1), NEG_INF)
        _, idx = torch.sort(choice, dim=-1, descending=True, stable=True)
        idx = idx[:, :k]
        w = scores.gather(1, idx)
        w = w / (w.sum(dim=-1, keepdim=True) + 1e-20) * m.routed_scale
        # the sequence-wise balance loss
        probs = scores / scores.sum(dim=-1, keepdim=True)
        b, s = batch_shape or (1, t)
        slots = torch.zeros((b, n), dtype=torch.float32, device=x.device)
        slots.scatter_add_(1, idx.reshape(b, s * k),
                           torch.ones((b, s * k), device=x.device))
        f = slots * (n / (k * s))
        aux = (f * probs.reshape(b, s, n).mean(dim=1)).sum(dim=-1).mean() \
            * m.router_aux_coef
    else:
        probs = torch.softmax(logits, dim=-1)
        w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
        w, idx = w[:, :k], idx[:, :k]
        w = w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-9)
        # Switch-style load-balance auxiliary loss
        me = probs.mean(dim=0)                                    # (E,)
        ce = _one_hot(idx.reshape(-1), n).sum(dim=0).float() / (t * k)
        aux = n * torch.sum(me * ce) * m.router_aux_coef
    return w, idx, aux


def _capacity(cfg, n_tokens: int) -> int:
    """Slots per expert: rounded up to 8, at least 8 (the JAX package's
    rule; it decides which slots drop). Under DeepSeek-V3's sigmoid
    router, which drops nothing, a row for every token: a token routes at
    most one slot to an expert, so no expert's slots can pass it."""
    m = cfg.moe
    if m.scoring == "sigmoid":
        return max(8, -(-n_tokens // 8) * 8)
    c = int(math.ceil(n_tokens * m.top_k / m.n_experts * m.capacity_factor))
    return max(8, -(-c // 8) * 8)


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """(S,) -> (S, n) int32 by comparison (``one_hot`` checks its input's
    range on the host, a device sync per call)."""
    return (idx[:, None] == torch.arange(n, device=idx.device)).int()


def _dispatch_indices(idx: torch.Tensor, n_experts: int, capacity: int,
                      held: Optional[torch.Tensor] = None):
    """slot -> (expert, position-in-expert) with capacity dropping.

    idx: (T*k,) expert id per slot, slots in token-major order; ``held``
    (T*k,) bool, where given, marks the slots whose expert this layer
    holds (``idx`` then counts from the first held expert, and the
    others take no row and count nowhere). Returns
    (pos (T*k,), keep (T*k,) bool, fill (E,) int32): a slot's position
    counts the earlier slots routed to the same expert; ``fill[e]`` is
    how many rows of expert e's buffer the kept slots take, min(count,
    capacity), rows 0..fill-1. The count is a scan along the slot axis of
    the transposed (E, T*k) one-hot, which the card runs as one row per
    expert (the (T*k, E) layout's scan over the outer axis took ~6 ms per
    layer at the training path's shape); its last column is each
    expert's count, so the fill costs no host sync."""
    if held is not None:
        # an absent expert's slot one-hots to a zero row: it counts
        # nowhere, so the scan is (E held, T*k)
        idx = torch.where(held, idx, n_experts)
    counts = _one_hot(idx, n_experts).T.contiguous().cumsum(dim=1) - 1
    if held is not None:
        idx = torch.where(held, idx, 0)
    pos = counts.gather(0, idx[None, :])[0].long()
    keep = pos < capacity
    if held is not None:
        keep = keep & held
    fill = torch.clamp(counts[:, -1] + 1, max=capacity).int()
    return pos, keep, fill


def _run_experts(cfg, x, w, eidx, pos, keep, fill, cap, wg, wu, wd):
    """Slots routed to (expert ``eidx``, row ``pos``) where ``keep``
    (each (T*k,), token-major) gather their tokens of x (T, d) into
    (E, cap, d) buffers over the E experts of wg/wu/wd, run the expert
    SwiGLU and combine back weighted by w (T, k). Returns (T, d)."""
    t, d = x.shape
    e, k = wg.shape[0], w.shape[1]
    with span("moe.dispatch"):
        # kept slots own their row; dropped slots write zeros to the
        # spare row E*C. Slot s holds token s // k: an expand, whose
        # backward is a sum over k (an index's backward would be a
        # sort-based scatter)
        rows = torch.where(keep, eidx * cap + pos,
                           torch.full_like(pos, e * cap))
        tokens = x[:, None, :].expand(t, k, d).reshape(t * k, d)
        vals = torch.where(keep[:, None], tokens, 0)
        flat = x.new_zeros((e * cap + 1, d)).index_put((rows,), vals)
        buf = flat[:e * cap].reshape(e, cap, d)
    # expert e's rows past fill[e] are zero: the kernel skips their tiles
    backend = model_backend(cfg)
    with span("moe.experts"):
        if dispatch.use_kernel(backend, x.device):
            out = ops.moe_expert_ffn(buf, wg, wu, wd, fill=fill,
                                     backend=backend)
        else:
            out = expert_ffn_reference(buf, wg, wu, wd, fill=fill)
    with span("moe.combine"):
        # combine back: the k contributions of each token, in slot order.
        # index_select's backward adds into unique rows but for the
        # dropped slots' zeros, so its result does not depend on the
        # order of adds
        safe = torch.where(keep, eidx * cap + pos, torch.zeros_like(pos))
        gathered = torch.where(keep[:, None], torch.index_select(
            out.reshape(e * cap, d), 0, safe), 0)
        scale = w.reshape(-1)[:, None].to(x.dtype)
        contrib = (gathered * scale).reshape(t, k, d)
        y = contrib[:, 0]
        for j in range(1, k):
            y = y + contrib[:, j]
    return y


def moe_block(params: dict, cfg, x: torch.Tensor, *,
              capacity: Optional[int] = None, mesh=None,
              constrain: bool = False, batch_shape=None):
    """x: (T, d) flattened tokens -> (y (T, d), aux_loss).

    ``batch_shape`` (B, S) with B S = T gives the sequence-wise aux loss
    its sequences (one sequence of T where None).

    An expert share (``router_width`` over ``n_experts``, DeepSeek-V3's
    8 of 256 a chip under 32-way expert parallelism): the router runs
    over every expert, and the layer computes the part of the result its
    ``n_experts`` experts from ``first_expert`` on give, for the slots
    routed to them; what absent experts would add is left out (on one
    card the layer runs without its exchange). A shared expert is added
    once.

    ``mesh`` and ``constrain`` are the JAX package's ``gather_sharded``
    path: there they pin the dispatch buffers' layout
    (``with_sharding_constraint``), which changes no value. Eager torch
    has no layout to pin on plain tensors, so they change nothing here
    and the result is the ``gather`` path's, bit for bit."""
    del mesh, constrain
    m = cfg.moe
    t = x.shape[0]
    cap = capacity or _capacity(cfg, t)
    with span("moe.route"):
        w, idx, aux = router_topk(params, cfg, x, batch_shape)     # (T,k)
    flat_idx = idx.reshape(-1)                                    # (T*k,)
    held = None
    with span("moe.dispatch"):
        if m.router_width != m.n_experts:
            held = (flat_idx >= m.first_expert) \
                & (flat_idx < m.first_expert + m.n_experts)
            flat_idx = flat_idx - m.first_expert
        pos, keep, fill = _dispatch_indices(flat_idx, m.n_experts, cap, held)
    count_moe(keep, held=held)
    y = _run_experts(cfg, x, w, flat_idx, pos, keep, fill, cap,
                     params["wg"], params["wu"], params["wd"])
    if "shared" in params:
        y = y + mlp(params["shared"], x[None])[0]
    return y, aux


class _SumOver(torch.autograd.Function):
    """All-reduce (sum) over ``group``; the gradient passes through as it
    is. JAX's ``psum`` inside ``shard_map``: values that differ by rank
    summed into one the whole group holds, whose gradient each rank
    already holds whole (Megatron's reduce from the tensor-parallel
    region)."""

    @staticmethod
    def forward(ctx, t, group):
        t = t.clone()
        dist.all_reduce(t, group=group)
        return t

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _CopyTo(torch.autograd.Function):
    """The identity; the gradient is all-reduced (summed) over
    ``group``: a value the whole group holds, feeding work that differs
    by rank, gets every rank's share of its gradient (Megatron's copy to
    the tensor-parallel region)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def moe_block_ep(params: dict, cfg, x: torch.Tensor, *, mesh,
                 tp_axis: str = "model", capacity: Optional[int] = None):
    """Expert-parallel path (the JAX package's ``moe_block_ep``): x
    (T_local, d) is this rank's tokens, its shard of the data axes, the
    same on every rank of ``tp_axis``; the expert weights are the whole
    (E, ...) tensors, of which this rank runs the E/tp experts its
    coordinate on ``tp_axis`` owns. Returns (y (T_local, d), aux).

    Per rank: the router over its tokens; the slots routed to its
    experts into (E/tp, cap_l, d) buffers, ``cap_l = max(8, ceil(T_local
    k / E) 2)`` (JAX's rule here, not ``_capacity``'s), a slot dropping
    where its position reaches cap_l; the expert SwiGLU through
    ``dispatch`` (the ``moe_expert_ffn`` kernel on the card, with the
    fill); the combine; the outputs summed over ``tp_axis``. The aux loss
    is the router's over the rank's tokens, averaged over the data axes
    (JAX's ``pmean``). A group of one rank runs no collective.

    Gradients are JAX's: y's and aux's reach each rank whole (the sum's
    backward is the identity), and the tokens and routing weights that
    feed the rank's own experts get the sum over ``tp_axis`` of every
    rank's share. An expert weight gets the gradient of this rank's
    tokens only: summing it over the data axes, as a data-parallel
    optimizer does, gives JAX's. ``capacity`` is not read, as in JAX."""
    del capacity
    m = cfg.moe
    names = mesh.mesh_dim_names
    tp = mesh.shape[names.index(tp_axis)]
    e_local = m.n_experts // tp
    lo = mesh.get_local_rank(tp_axis) * e_local
    t_l = x.shape[0]
    cap_l = max(8, -(-t_l * m.top_k // m.n_experts) * 2)

    with span("moe.route"):
        w, idx, aux = router_topk(params, cfg, x)
    flat_idx = idx.reshape(-1)
    with span("moe.dispatch"):
        local = (flat_idx >= lo) & (flat_idx < lo + e_local)
        loc_idx = torch.where(local, flat_idx - lo, e_local)  # drop bin
        pos, keep, fill = _dispatch_indices(loc_idx, e_local + 1, cap_l)
        keep = keep & local
    count_moe(keep, local, held=local)
    xs, ws = x, w
    if tp > 1:
        group = mesh.get_group(tp_axis)
        xs, ws = _CopyTo.apply(x, group), _CopyTo.apply(w, group)
    sl = slice(lo, lo + e_local)
    y = _run_experts(cfg, xs, ws, loc_idx, pos, keep, fill[:e_local], cap_l,
                     params["wg"][sl], params["wu"][sl], params["wd"][sl])
    if tp > 1:
        y = _SumOver.apply(y, group)
    if "shared" in params:
        y = y + mlp(params["shared"], x[None])[0]
    n_data = 1
    for a in names:
        size = mesh.shape[names.index(a)]
        if a != tp_axis and size > 1:
            aux = _SumOver.apply(aux, mesh.get_group(a))
            n_data *= size
    return y, aux / n_data if n_data > 1 else aux
