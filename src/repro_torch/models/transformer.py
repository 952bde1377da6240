"""The whole model, for training, prefill and decoding: GQA attention
blocks with a SwiGLU MLP (``gqa_mlp``: qwen2-7b, llama2-7b-proxy,
phi4-mini, qwen3, minicpm) or a top-k MoE (``gqa_moe``: granite-moe),
attention-free Mamba-2 blocks (``mamba_only``: mamba2-2.7b), the hybrid
order of jamba-v0.1 (``mamba_mlp``, ``mamba_moe`` and ``gqa_mlp`` stacks
interleaved by ``hybrid_order``), and deepseek-v3's MLA blocks
(``mla_mlp`` for the dense prefix, then ``mla_moe`` with the shared
expert; rotary tables over ``qk_rope_head_dim``), and the two frontend
orders: qwen2-vl's M-RoPE with its vision prefix (``vision_embeds``
projected through ``vis_proj`` and prepended to the text; without a
prefix the three position streams are equal and M-RoPE is RoPE) and
whisper-tiny's encoder-decoder order (``enc`` blocks, non-causal over
``audio_embeds`` and frozen, then ``dec`` blocks with a cross-attention
to per-layer K/V of the encoder's output). Every kind of the JAX
package trains, runs DevFT's submodels and decodes here.

Parameters keep the JAX package's *stacked* layout: every leaf of a
layer stack carries a leading ``(L, ...)`` layer axis, so DevFT's
grouping and fusion can later act on that axis unchanged. Where the JAX
package runs a stack with ``lax.scan``, this module runs a Python loop
over layers, taking per-layer views; there is no jit, scan, vmap or
buffer donation. The hybrid order runs layer by layer in
``execution_order``, as the JAX package's unrolled loop does.
``decode_step`` writes the caches in place (K/V rows, the Mamba conv
window and SSM state) through those per-layer views.

Meshes (``launch.mesh``): frozen params placed on a mesh as DTensors
(``launch.sharding.place``) are gathered whole one layer at a time
(``_layer``), and the leaves outside the layer stacks once per call, so
the base stays sharded between layers; on a 1x1 mesh a gather is a copy.
``moe_path`` picks the MoE blocks' path as in the JAX package:
``gather`` (``moe_block``), ``gather_sharded`` (``moe_block`` with the
JAX package's layout hints, the same values) or ``ep``
(``moe_block_ep`` on ``mesh``).
``remat`` checkpoints each block as the JAX package wraps each layer's
body in ``jax.checkpoint``: ``True`` with ``torch.utils.checkpoint``
(non-reentrant), which recomputes the whole block in the backward, and
the six plain ``jax.checkpoint_policies`` names through a selective
checkpoint that keeps the outputs of the matmul ops the policy names
(``REMAT_POLICIES``). The hand kernels launch through ctypes inside
autograd Functions, where the policy cannot see them, so every policy
that checkpoints runs them again in the recompute, as JAX recomputes a
``pallas_call`` under its dot policies.

As in the JAX package, decoding fills no cross-attention cache:
``init_cache`` zeros ``cross_k``/``cross_v`` and the serving engine
never writes them; ``encoder_kv`` computes them for a caller that does.

Public API:
    init_params(cfg, gen, dtype)                  -> params
    init_lora(cfg, gen, rank, dtype)              -> lora (mirrors stacks)
    init_cache(cfg, batch, capacity, dtype, device)
    forward_hidden(cfg, params, lora, batch)      -> (h, aux, n_prefix)
    encoder_kv(cfg, params, audio_embeds)         -> (cross K, cross V)
    loss_fn(cfg, params, lora, batch)             -> (loss, metrics)
    loss_and_lora_grads(cfg, params, lora, batch) -> (loss, metrics, grads)
    prefill(cfg, params, lora, batch)             -> last-token logits
    decode_step(cfg, params, lora, token, cache)  -> (logits, cache)
    execution_order(cfg, sizes)                   -> [(stack, index), ...]
"""
from __future__ import annotations

import functools
import math
from typing import Dict, FrozenSet, Optional

import torch
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.interop import tree_leaves, tree_map, tree_paths
from repro_torch.models import layers as Lyr
from repro_torch.models import mamba2 as Mb
from repro_torch.models import moe as Moe

#: block kinds this package trains and decodes: every kind of the JAX
#: package (``enc`` runs in training and prefill only)
PORTED_KINDS = ("gqa_mlp", "gqa_moe", "mamba_only", "mamba_mlp",
                "mamba_moe", "mla_mlp", "mla_moe", "enc", "dec")


def stack_kinds(cfg) -> Dict[str, str]:
    """stack name -> block kind (the JAX package's table)."""
    if cfg.family == "hybrid":
        return {"mamba_mlp": "mamba_mlp", "mamba_moe": "mamba_moe",
                "attn_mlp": "gqa_mlp"}
    if cfg.is_encdec:
        return {"enc": "enc", "dec": "dec"}
    if cfg.moe is not None and cfg.moe.first_dense_layers:
        return {"dense": "mla_mlp" if cfg.attn_kind == "mla" else "gqa_mlp",
                "moe": "mla_moe" if cfg.attn_kind == "mla" else "gqa_moe"}
    if cfg.moe is not None:
        return {"layers": "gqa_moe"}
    if cfg.family == "ssm":
        return {"layers": "mamba_only"}
    return {"layers": "gqa_mlp"}


def stack_sizes(blocks: dict) -> Dict[str, int]:
    """Actual per-stack depth, read off the params."""
    return {name: tree_leaves(stack)[0].shape[0]
            for name, stack in blocks.items()}


def hybrid_order(sizes: Dict[str, int]):
    """The JAX package's interleave for (sub)models of the hybrid family:
    attention layers evenly spaced at the period's middle (Jamba's 1 in
    8 at offset 4 for the full model), MoE on alternating Mamba slots
    (MoE every 2nd layer); any stack sizes, so DevFT submodels run.
    Returns [(stack name, index within the stack), ...]."""
    mm, mo, at = (sizes.get("mamba_mlp", 0), sizes.get("mamba_moe", 0),
                  sizes.get("attn_mlp", 0))
    total = mm + mo + at
    period = max(total // max(at, 1), 1)
    attn_pos = {k * period + period // 2 for k in range(at)}
    order, c = [], {"mamba_mlp": 0, "mamba_moe": 0, "attn_mlp": 0}
    for i in range(total):
        if i in attn_pos and c["attn_mlp"] < at:
            name = "attn_mlp"
        elif (i % 2 == 1 and c["mamba_moe"] < mo) or c["mamba_mlp"] >= mm:
            name = "mamba_moe" if c["mamba_moe"] < mo else "mamba_mlp"
        else:
            name = "mamba_mlp"
        order.append((name, c[name]))
        c[name] += 1
    return order


def execution_order(cfg, sizes: Optional[Dict[str, int]] = None):
    """[(stack name, index within the stack), ...] in layer execution
    order: homogeneous stacks one after another, the hybrid family by
    ``hybrid_order``. ``sizes`` overrides the config's depths
    (submodels)."""
    if sizes is None:
        sizes = dict(cfg.layer_stacks())
    if cfg.family == "hybrid":
        return hybrid_order(sizes)
    return [(name, i) for name, _ in cfg.layer_stacks()
            for i in range(sizes.get(name, 0))]


def _init_block(gen: torch.Generator, cfg, kind: str, dtype,
                n: int) -> dict:
    """One stack of ``n`` blocks of ``kind``, every leaf ``(n, ...)``."""
    d = cfg.d_model
    dev = gen.device
    assert kind in PORTED_KINDS, kind
    ln1 = torch.ones((n, d), dtype=dtype, device=dev)
    if kind.startswith("mamba"):
        mixer = Mb.init_mamba(gen, cfg, dtype, lead=(n,))
        if kind == "mamba_only":
            return {"ln1": ln1, "mixer": mixer}
    elif kind.startswith("mla"):
        mixer = Lyr.init_mla(gen, cfg, dtype, lead=(n,))
    else:                                               # gqa, enc, dec
        mixer = Lyr.init_gqa(gen, cfg, dtype, lead=(n,))
    p = {
        "ln1": ln1,
        "mixer": mixer,
        "ln2": torch.ones((n, d), dtype=dtype, device=dev),
        "ffn": Moe.init_moe(gen, cfg, dtype, lead=(n,))
        if kind.endswith("moe")
        else Lyr.init_mlp(gen, d, cfg.d_ff, dtype, lead=(n,)),
    }
    if kind == "dec":
        p["lnx"] = torch.ones((n, d), dtype=dtype, device=dev)
        p["cross"] = Lyr.init_gqa(gen, cfg, dtype, lead=(n,))
    return p


def _block_lora_targets(cfg, kind: str):
    """Which mixer projections get LoRA (paper: W_q / W_v; Mamba-2: the
    in and out projections; MLA: the query and key/value
    up-projections), with their (d_in, d_out)."""
    assert kind in PORTED_KINDS, kind
    d = cfg.d_model
    if kind.startswith("mamba"):
        return {"in_proj": (d, 2 * Mb.d_inner(cfg)
                            + 2 * cfg.mamba.n_groups * cfg.mamba.d_state
                            + Mb.n_heads(cfg)),
                "out_proj": (Mb.d_inner(cfg), d)}
    if kind.startswith("mla"):
        m = cfg.mla
        return {"wq_b": (m.q_lora_rank, cfg.n_heads
                         * (m.qk_nope_head_dim + m.qk_rope_head_dim)),
                "wkv_b": (m.kv_lora_rank, cfg.n_heads
                          * (m.qk_nope_head_dim + m.v_head_dim))}
    return {"wq": (d, cfg.n_heads * cfg.hd),
            "wv": (d, cfg.n_kv_heads * cfg.hd)}


def init_params(cfg, gen: torch.Generator, dtype=None) -> dict:
    """Random parameters on ``gen.device`` (``cfg.dtype`` by default)."""
    dtype = dtype or getattr(torch, cfg.dtype)
    dev = gen.device
    d, vp = cfg.d_model, cfg.padded_vocab
    params = {
        "embed": Lyr._randn(gen, (vp, d), dtype, 0.02),
        "final_norm": torch.ones((d,), dtype=dtype, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = Lyr._randn(gen, (d, vp), dtype,
                                       1.0 / math.sqrt(d))
    if cfg.frontend == "vision":
        params["vis_proj"] = Lyr._randn(gen, (d, d), dtype,
                                        1.0 / math.sqrt(d))
    sizes = dict(cfg.layer_stacks())
    params["blocks"] = {
        name: _init_block(gen, cfg, kind, dtype, sizes[name])
        for name, kind in stack_kinds(cfg).items()}
    if cfg.is_encdec:
        params["enc_norm"] = torch.ones((d,), dtype=dtype, device=dev)
    return params


def init_lora(cfg, gen: torch.Generator, rank: int = 32,
              dtype=torch.float32) -> dict:
    """LoRA tree mirroring ``params['blocks']``: ``a`` random, ``b``
    zero (the adapter starts as the identity). The encoder (``enc``)
    stays frozen whole and gets none."""
    dev = gen.device
    sizes = dict(cfg.layer_stacks())
    out = {}
    for name, kind in stack_kinds(cfg).items():
        if kind == "enc":
            continue
        n = sizes[name]
        out[name] = {
            pname: {"a": Lyr._randn(gen, (n, din, rank), dtype,
                                    1.0 / math.sqrt(din)),
                    "b": torch.zeros((n, rank, dout), dtype=dtype,
                                     device=dev)}
            for pname, (din, dout) in sorted(
                _block_lora_targets(cfg, kind).items())}
    return out


# ---------------------------------------------------------------------------
# Forward (train / prefill)
# ---------------------------------------------------------------------------


def _ffn(p, cfg, kind, x, *, moe_path="gather", mesh=None):
    """Returns (y, aux): the MoE block's router loss, or a zero f32 scalar
    for a dense MLP."""
    if kind.endswith("moe"):
        b, s, d = x.shape
        flat = x.reshape(b * s, d)
        if moe_path == "ep":
            y, aux = Moe.moe_block_ep(p["ffn"], cfg, flat, mesh=mesh)
        elif moe_path == "gather_sharded":
            y, aux = Moe.moe_block(p["ffn"], cfg, flat, mesh=mesh,
                                   constrain=True)
        else:
            y, aux = Moe.moe_block(p["ffn"], cfg, flat)
        return y.reshape(b, s, d), aux
    return Lyr.mlp(p["ffn"], x), torch.zeros((), dtype=torch.float32,
                                             device=x.device)


def _cross_attention(p, cfg, x, cos, sin, ek, ev, backend="reference"):
    """A ``dec`` block's cross-attention residual: q from ``lnx``-normed
    x through ``cross`` with the identity rotation (``cos * 0 + 1``,
    ``sin * 0``: the JAX package's ops, so q is the same bits) and no
    adapter, non-causal over the encoder's K/V ``ek``/``ev`` (B, Senc,
    Hkv, hd), out through ``cross.wo``. Sq differs from Senc, so
    ``attend`` keeps it plain whatever the backend."""
    hx = Lyr.rms_norm(x, p["lnx"], cfg.norm_eps)
    q, _, _ = Lyr.gqa_qkv(p["cross"], cfg, hx, cos * 0 + 1, sin * 0,
                          lora=None)
    cx = Lyr.attend(q, ek, ev, causal=False, backend=backend)
    return x + Lyr._matmul(cx.reshape(x.shape[0], x.shape[1], -1),
                           p["cross"]["wo"])


def block_forward(p, cfg, kind, x, cos, sin, lora=None, *, window=None,
                  causal=True, enc_out=None, moe_path="gather", mesh=None):
    """Pre-norm residual block over a whole sequence; a ``dec`` block
    given ``enc_out = (K, V)`` adds its cross-attention after the
    self-attention. Returns (y, aux)."""
    assert kind in PORTED_KINDS, kind
    h = Lyr.rms_norm(x, p["ln1"], cfg.norm_eps)
    if kind == "mamba_only":
        return x + Mb.mamba_forward(p["mixer"], cfg, h, lora=lora), \
            torch.zeros((), dtype=torch.float32, device=x.device)
    if kind.startswith("mamba"):
        x = x + Mb.mamba_forward(p["mixer"], cfg, h, lora=lora)
    elif kind.startswith("mla"):
        x = x + Lyr.mla_attention(p["mixer"], cfg, h, cos, sin, lora=lora,
                                  causal=causal, window=window)
    else:
        x = x + Lyr.gqa_attention(p["mixer"], cfg, h, cos, sin, lora=lora,
                                  window=window, causal=causal)
    if kind == "dec" and enc_out is not None:
        x = _cross_attention(p, cfg, x, cos, sin, *enc_out,
                             backend=Lyr.model_backend(cfg))
    h2 = Lyr.rms_norm(x, p["ln2"], cfg.norm_eps)
    y, aux = _ffn(p, cfg, kind, h2, moe_path=moe_path, mesh=mesh)
    return x + y, aux


def _embed_inputs(cfg, params, batch):
    """Returns (x (B,S,d), cos, sin, n_prefix). With qwen2-vl's vision
    frontend and ``vision_embeds`` (B, n_patches, d) in the batch, the
    patches (cast to the activations' dtype) go through ``vis_proj`` and
    precede the text, ``n_prefix`` of them, with M-RoPE tables over
    ``vlm_positions``; without them the three streams are ``arange(S)``.
    A pure SSM needs no rotary tables (cos = sin = None)."""
    tokens = _on_device(batch["tokens"], params["embed"].device)
    b, s_text = tokens.shape
    x = params["embed"][tokens]
    n_prefix = 0
    if cfg.frontend == "vision" and "vision_embeds" in batch:
        ve = _on_device(batch["vision_embeds"], x.device).to(x.dtype)
        ve = Lyr._matmul(ve, params["vis_proj"])
        x = torch.cat([ve, x], dim=1)
        n_prefix = ve.shape[1]
    s = x.shape[1]
    if cfg.mrope:
        pos3 = Lyr.vlm_positions(b, n_prefix, s_text, device=x.device) \
            if n_prefix else Lyr.text_positions(
                b, s, device=x.device)[None].expand(3, b, s)
        cos, sin = Lyr.mrope_cos_sin(pos3, cfg.mrope_sections, cfg.hd,
                                     cfg.rope_theta)
    elif cfg.attn_kind == "none":
        cos = sin = None
    else:
        cos, sin = Lyr.rope_cos_sin(Lyr.text_positions(b, s, device=x.device),
                                    rope_dim(cfg), cfg.rope_theta)
    return x, cos, sin, n_prefix


def rope_dim(cfg) -> int:
    """The rotary tables' head dim: MLA rotates only its
    ``qk_rope_head_dim`` part; 0 without attention heads."""
    if cfg.attn_kind == "mla":
        return cfg.mla.qk_rope_head_dim
    return cfg.hd if cfg.n_heads else 0


def _on_device(a, device) -> torch.Tensor:
    """A batch array (numpy or tensor) as a tensor on ``device``."""
    return torch.as_tensor(a).to(device)


def _full(a):
    """A DTensor gathered whole (a plain tensor as it is)."""
    return a.full_tensor() if isinstance(a, DTensor) else a


def _layer(stack, i: int):
    """Layer ``i``'s views of a stacked tree (None stays None); a DTensor
    leaf gives layer i gathered whole."""
    return None if stack is None else tree_map(lambda a: _full(a[i]), stack)


def _unplaced_top(params):
    """``params`` with its leaves outside the layer stacks gathered whole
    (the stacks are gathered layer by layer in ``_layer``)."""
    return {k: v if k == "blocks" else tree_map(_full, v)
            for k, v in params.items()}


_aten = torch.ops.aten
_DOTS = frozenset((_aten.mm, _aten.addmm, _aten.bmm, _aten.baddbmm))
#: a product with no batch dims: (B, S, D) @ (D, N) folds to ``mm``; the
#: attention ``einsum``s go to ``bmm`` (a ``dot_general`` with batch
#: dims in JAX)
_DOTS_2D = frozenset((_aten.mm, _aten.addmm))

#: the plain ``jax.checkpoint_policies`` names -> the aten ops whose
#: outputs a checkpointed block keeps for the backward. None: every op
#: (the block runs without a checkpoint, which is what JAX's policy
#: amounts to); empty: none (the same as ``remat=True``)
REMAT_POLICIES: Dict[str, Optional[FrozenSet]] = {
    "everything_saveable": None,
    "nothing_saveable": frozenset(),
    "dots_saveable": _DOTS,
    "checkpoint_dots": _DOTS,
    "dots_with_no_batch_dims_saveable": _DOTS_2D,
    "checkpoint_dots_with_no_batch_dims": _DOTS_2D,
}
#: the ``jax.checkpoint_policies`` that JAX builds from arguments (names,
#: an offload destination, two policies): a bare name cannot select them
FACTORY_POLICIES = ("save_only_these_names", "save_any_names_but_these",
                    "save_anything_except_these_names",
                    "save_and_offload_only_these_names",
                    "offload_dot_with_no_batch_dims",
                    "save_from_both_policies")


def remat_saved_ops(remat) -> Optional[FrozenSet]:
    """What a block keeps under ``remat`` (False | None | True | a plain
    policy name): None runs it without a checkpoint, an empty set
    recomputes it whole, else the aten ops whose outputs it keeps. A
    factory policy raises ``ValueError``, an unknown name
    ``AttributeError`` (JAX's ``getattr`` on ``jax.checkpoint_policies``)."""
    if remat is False or remat is None:
        return None
    if remat is True:
        return frozenset()
    if remat in FACTORY_POLICIES:
        raise ValueError(f"remat={remat!r}: the policy is built from "
                         f"arguments in JAX; a bare name selects only "
                         f"{sorted(REMAT_POLICIES)}")
    try:
        return REMAT_POLICIES[remat]
    except (KeyError, TypeError):
        raise AttributeError(f"jax.checkpoint_policies has no attribute "
                             f"{remat!r}") from None


def _keep_saved(saved, ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op.overloadpacket in saved
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_wrap(body, saved: Optional[FrozenSet]):
    """``body`` under ``saved`` (``remat_saved_ops``)."""
    if saved is None:
        return body
    kw = {}
    if saved:
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts,
            functools.partial(_keep_saved, saved))
    return lambda *a: checkpoint(body, *a, use_reentrant=False, **kw)


def _run_layers(cfg, blocks, lora, x, cos, sin, layers, *, window=None,
                causal=True, enc_kv=None, remat=False, moe_path="gather",
                mesh=None):
    """Run ``layers`` ([(stack, index), ...]) over x: per-layer views of
    the stacked leaves, each block checkpointed under ``remat``
    (``remat_saved_ops``); ``enc_kv`` = (K, V) with a leading
    decoder-layer axis gives each ``dec`` layer its own cross K/V.
    Returns (x, aux summed layer by layer as the JAX package's scan
    carries it)."""
    saved = remat_saved_ops(remat)
    kinds = stack_kinds(cfg)
    total_aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for name, i in layers:
        p = _layer(blocks[name], i)
        lo = _layer(lora.get(name) if lora else None, i)
        eo = None if enc_kv is None else (enc_kv[0][i], enc_kv[1][i])

        def body(xc, p=p, lo=lo, kind=kinds[name], eo=eo):
            return block_forward(p, cfg, kind, xc, cos, sin, lo,
                                 window=window, causal=causal, enc_out=eo,
                                 moe_path=moe_path, mesh=mesh)
        x, a = _remat_wrap(body, saved)(x)
        total_aux = total_aux + a
    return x, total_aux


def encoder_kv(cfg, params, audio_embeds, *, remat=False):
    """whisper's encoder: ``audio_embeds`` (B, Senc, d) (cast to the
    params' dtype) through every ``enc`` block, non-causal, with rotary
    tables over the frame positions and no adapter, then ``enc_norm``,
    then each decoder layer's cross K and V, (Ldec, B, Senc, Hkv, hd)
    each (``enc_h @ cross.wk`` / ``cross.wv``, no bias, as in the JAX
    package)."""
    blocks = params["blocks"]
    params = _unplaced_top(params)
    embed = params["embed"]
    enc_x = _on_device(audio_embeds, embed.device).to(embed.dtype)
    b, se = enc_x.shape[:2]
    ecos, esin = Lyr.rope_cos_sin(
        Lyr.text_positions(b, se, device=enc_x.device), cfg.hd,
        cfg.rope_theta)
    n_enc = stack_sizes(blocks)["enc"]
    enc_h, _ = _run_layers(cfg, blocks, None, enc_x, ecos, esin,
                           [("enc", i) for i in range(n_enc)], causal=False,
                           remat=remat)
    enc_h = Lyr.rms_norm(enc_h, params["enc_norm"], cfg.norm_eps)
    cross = {k: blocks["dec"]["cross"][k] for k in ("wk", "wv")}
    shape = (b, se, cfg.n_kv_heads, cfg.hd)
    ks, vs = zip(*[(Lyr._matmul(enc_h, c["wk"]).reshape(shape),
                    Lyr._matmul(enc_h, c["wv"]).reshape(shape))
                   for c in (_layer(cross, i)
                             for i in range(stack_sizes(blocks)["dec"]))])
    return torch.stack(ks), torch.stack(vs)


def forward_hidden(cfg, params, lora, batch, *, window=None, remat=False,
                   moe_path="gather", mesh=None):
    """Run every layer in ``execution_order`` (per-layer views of the
    stacked leaves); returns (final-normed hidden (B,S,d), aux, n_prefix):
    aux summed layer by layer as the JAX package's scan carries it,
    ``n_prefix`` the vision tokens ahead of the text. The enc-dec order
    runs ``encoder_kv`` over ``batch['audio_embeds']`` first (a batch
    without them raises ``KeyError``, as in the JAX package), then the
    decoder over the text."""
    remat_saved_ops(remat)              # a bad name raises before any work
    params = _unplaced_top(params)
    x, cos, sin, n_prefix = _embed_inputs(cfg, params, batch)
    sizes = stack_sizes(params["blocks"])
    enc_kv = None
    if cfg.is_encdec:
        enc_kv = encoder_kv(cfg, params, batch["audio_embeds"], remat=remat)
        layers = [("dec", i) for i in range(sizes["dec"])]
    else:
        layers = execution_order(cfg, sizes)
    x, total_aux = _run_layers(cfg, params["blocks"], lora, x, cos, sin,
                               layers, window=window, enc_kv=enc_kv,
                               remat=remat, moe_path=moe_path, mesh=mesh)
    return (Lyr.rms_norm(x, params["final_norm"], cfg.norm_eps), total_aux,
            n_prefix)


def loss_fn(cfg, params, lora, batch, *, window=None, remat=False,
            moe_path="gather", mesh=None):
    """Next-token cross-entropy on the text region (the vision prefix's
    rows are dropped before the logits). Returns (total, {"loss", "aux",
    "acc"}); labels < 0 are masked out."""
    params = _unplaced_top(params)
    h, aux, n_prefix = forward_hidden(cfg, params, lora, batch,
                                      window=window, remat=remat,
                                      moe_path=moe_path, mesh=mesh)
    if n_prefix:
        h = h[:, n_prefix:]
    logits = logits_from_hidden(cfg, params, h).float()
    labels = _on_device(batch["labels"], logits.device).long()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels.clamp(min=0)[..., None])[..., 0]
    mask = (labels >= 0).float()
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = (nll * mask).sum() / denom
    acc = ((torch.argmax(logits, -1) == labels) * mask).sum() / denom
    return loss + aux, {"loss": loss, "aux": aux, "acc": acc}


def loss_and_lora_grads(cfg, params, lora, batch, *, window=None,
                        remat=False, moe_path="gather", mesh=None):
    """``jax.value_and_grad(loss_fn, has_aux=True)`` with respect to the
    LoRA tree: returns (total, metrics, grads), grads a tree like
    ``lora`` in the leaves' dtypes. The frozen params get no gradient;
    the inputs are left untouched (the leaves are differentiated through
    detached copies). The leaves of an empty stack (a submodel's, zero
    layers) get zeros, as in JAX; any other leaf the loss does not reach
    raises."""
    lo = tree_map(lambda t: t.detach().requires_grad_(True), lora)
    paths = tree_paths(lo)
    leaves = [t for _, t in paths]
    with torch.enable_grad():
        total, metrics = loss_fn(cfg, params, lo, batch, window=window,
                                 remat=remat, moe_path=moe_path, mesh=mesh)
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
    unreached = [path for (path, t), g in zip(paths, grads)
                 if g is None and t.shape[0] > 0]
    if unreached:
        raise RuntimeError(f"the loss does not reach LoRA leaves {unreached}")
    by_leaf = {id(t): torch.zeros_like(t) if g is None else g
               for t, g in zip(leaves, grads)}
    return (total.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_map(lambda t: by_leaf[id(t)], lo))


def prefill(cfg, params, lora, batch, *, window=None, moe_path="gather",
            mesh=None):
    """Full-sequence forward; returns the last token's logits (B, 1, Vp)."""
    params = _unplaced_top(params)
    h, _aux, _n_prefix = forward_hidden(cfg, params, lora, batch,
                                        window=window, moe_path=moe_path,
                                        mesh=mesh)
    return logits_from_hidden(cfg, params, h[:, -1:])


# ---------------------------------------------------------------------------
# Serving: decode
# ---------------------------------------------------------------------------


def block_decode(p, cfg, kind, x, cache, pos, cos, sin, lora=None, *,
                 moe_path="gather", mesh=None):
    """Single-token pre-norm residual block; writes ``cache`` in place.
    ``mamba_only`` takes its Mamba cache as is, the other kinds under
    ``"mixer"``; a ``dec`` block also attends (plain, as in the JAX
    package) over its ``cross_k``/``cross_v``. Returns (y, cache)."""
    h = Lyr.rms_norm(x, p["ln1"], cfg.norm_eps)
    if kind == "mamba_only":
        mix, cache = Mb.mamba_decode(p["mixer"], cfg, h, cache, lora=lora)
        return x + mix, cache
    if kind.startswith("mamba"):
        mix, cache["mixer"] = Mb.mamba_decode(p["mixer"], cfg, h,
                                              cache["mixer"], lora=lora)
    elif kind.startswith("mla"):
        mix, cache["mixer"] = Lyr.mla_decode(p["mixer"], cfg, h,
                                             cache["mixer"], pos, cos, sin,
                                             lora=lora)
    else:
        mix, cache["mixer"] = Lyr.gqa_decode(p["mixer"], cfg, h,
                                             cache["mixer"], pos, cos, sin,
                                             lora=lora)
    x = x + mix
    if kind == "dec":
        x = _cross_attention(p, cfg, x, cos, sin, cache["cross_k"],
                             cache["cross_v"])
    h2 = Lyr.rms_norm(x, p["ln2"], cfg.norm_eps)
    y, _aux = _ffn(p, cfg, kind, h2, moe_path=moe_path, mesh=mesh)
    return x + y, cache


def _init_block_cache(cfg, kind, batch, capacity, dtype, device, lead):
    if kind == "mamba_only":
        return Mb.init_mamba_cache(cfg, batch, dtype, device, lead=lead)
    if kind.startswith("mamba"):
        return {"mixer": Mb.init_mamba_cache(cfg, batch, dtype, device,
                                             lead=lead)}
    if kind.startswith("mla"):
        return {"mixer": Lyr.init_mla_cache(cfg, batch, capacity, dtype,
                                            device, lead=lead)}
    c = {"mixer": Lyr.init_gqa_cache(cfg, batch, capacity, dtype, device,
                                     lead=lead)}
    if kind == "dec":
        shape = (*lead, batch, cfg.n_frontend_tokens, cfg.n_kv_heads, cfg.hd)
        c["cross_k"] = torch.zeros(shape, dtype=dtype, device=device)
        c["cross_v"] = torch.zeros(shape, dtype=dtype, device=device)
    return c


def init_cache(cfg, batch: int, capacity: int, dtype=None,
               device="cuda") -> dict:
    """Stacked decode cache: per stack its kind's cache with leaves of
    shape (L, B, ...) — attention ``{'mixer': {'k', 'v'}}`` of (L, B, C,
    Hkv, hd); MLA ``{'mixer': {'c', 'k_rope'}}`` of (L, B, C,
    kv_lora_rank) and (L, B, C, qk_rope_head_dim); Mamba ``{'conv',
    'ssm'}`` (``mamba_only``) or the same under ``'mixer'``, ``ssm`` in
    f32; ``dec`` adds zero ``cross_k``/``cross_v`` of (L, B,
    n_frontend_tokens, Hkv, hd) and ``enc`` has none — and per-slot
    positions ``pos (B,)``."""
    dtype = dtype or getattr(torch, cfg.dtype)
    sizes = dict(cfg.layer_stacks())
    stacks = {name: _init_block_cache(cfg, kind, batch, capacity, dtype,
                                      device, (sizes[name],))
              for name, kind in stack_kinds(cfg).items() if kind != "enc"}
    return {"stacks": stacks,
            "pos": torch.zeros((batch,), dtype=torch.int32, device=device)}


def logits_from_hidden(cfg, params, h):
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return Lyr._matmul(h, w)


def decode_step(cfg, params, lora, token, cache, *, moe_path="gather",
                mesh=None):
    """One-token decode. token: (B, 1) int. Runs every layer in
    ``execution_order``, writing its cache (K/V rows, MLA's latent and
    rotary key, or the conv window and SSM state) in place through
    per-layer views, and returns (logits
    (B, 1, Vp), {"stacks": the same stacks, "pos": pos + 1});
    ``cache["pos"]`` itself is left as it was, so a caller can keep the
    old cursor of an inactive slot. A config without attention heads
    gets zero rotary tables, and an M-RoPE config its tables at ``pos``
    in all three streams, as in the JAX package. The encoder does not
    run: ``dec`` layers attend over the cache's ``cross_k``/``cross_v``."""
    params = _unplaced_top(params)
    x = params["embed"][token]
    b = token.shape[0]
    pos = cache["pos"]
    if cfg.mrope:
        cos, sin = Lyr.mrope_cos_sin(pos[None, :, None].expand(3, b, 1),
                                     cfg.mrope_sections, cfg.hd,
                                     cfg.rope_theta)
    elif rope_dim(cfg):
        cos, sin = Lyr.rope_cos_sin(pos[:, None], rope_dim(cfg),
                                    cfg.rope_theta)
    else:
        cos = sin = torch.zeros((b, 1, 1), dtype=torch.float32,
                                device=x.device)
    kinds = stack_kinds(cfg)
    for name, i in execution_order(cfg, stack_sizes(params["blocks"])):
        if kinds[name] == "enc":
            continue
        x, _ = block_decode(_layer(params["blocks"][name], i), cfg,
                            kinds[name], x,
                            _layer(cache["stacks"][name], i), pos, cos, sin,
                            _layer(lora.get(name) if lora else None, i),
                            moe_path=moe_path, mesh=mesh)
    h = Lyr.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = logits_from_hidden(cfg, params, h)
    # mask vocab padding so greedy decode never emits a pad id
    vmask = torch.arange(cfg.padded_vocab, device=logits.device) < cfg.vocab
    logits = torch.where(vmask, logits, Lyr.NEG_INF)
    return logits, {"stacks": cache["stacks"], "pos": pos + 1}
