"""Shared transformer primitives: RMSNorm, RoPE and Qwen2-VL's M-RoPE
(with its position streams), grouped-query attention, MLA (deepseek-v3's
multi-head latent attention), the LoRA projection and the SwiGLU MLP.

Kernel branches, as in the JAX package: ``attend`` sends calls that fit
the flash kernel's contract (``_flash_eligible``) to ``flash_attention``,
and ``_proj`` sends frozen-weight products that carry a 2-D LoRA adapter
to the fused ``lora_matmul``, whenever ``dispatch.use_kernel(backend,
device)`` holds — on the card under ``auto``/``pallas``. Otherwise (the
CPU, the ``reference`` backend, per-slot serving adapters, ragged
caches) they run the plain math below. The decode path never passes a
backend, so serving never reaches either kernel.

Plain functions on tensors; parameters are nested dicts of tensors.
Layer functions take *unstacked* (single-layer) params — the stacked
``(L, ...)`` layout and the loop over layers live in
``repro_torch.models.transformer``.

Shapes follow the JAX package: activations ``(B, S, d)``, per-head
tensors ``(B, S, H, hd)``.

Dtype promotion: JAX promotes mixed operands of a matrix product
silently (f32 activations against a bf16 KV cache, bf16 attention
output against f32 ``wo``); ``torch.matmul`` refuses them. ``_matmul``
and ``_einsum`` cast both operands to ``torch.promote_types`` first,
which is what JAX's promotion gives for f32/bf16.

``gqa_decode`` writes the new K/V into the cache **in place** (JAX
returns an updated copy) and routes the attention through the
``flash_decode`` kernel for the device of its inputs; ``mla_decode``
does the same with MLA's latent cache, in the absorbed formulation.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import dispatch, ops
from repro_torch.kernels.common import NEG_INF


def _matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.matmul(a.to(dt), b.to(dt))


def _einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dt), b.to(dt))


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(dt) * scale


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions: (B, S) int -> cos/sin (B, S, head_dim//2) float32."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32,
                        device=positions.device) / half
    inv_freq = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * inv_freq            # (B,S,half)
    return torch.cos(ang), torch.sin(ang)


def mrope_cos_sin(positions: torch.Tensor, sections: Tuple[int, ...],
                  head_dim: int, theta: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Qwen2-VL's multimodal RoPE. positions: (3, B, S) int — the
    temporal, height and width streams; ``sections`` splits the
    head_dim//2 frequency slots between them ((16, 24, 24) for head_dim
    128). Text tokens carry one position in all three streams, which
    gives ``rope_cos_sin``'s tables bit for bit (the angles are the same
    products, laid out the same way)."""
    half = head_dim // 2
    assert sum(sections) == half, (sections, half)
    dev = positions.device
    exps = torch.arange(half, dtype=torch.float32, device=dev) / half
    inv_freq = 1.0 / (theta ** exps)
    # stream id of each frequency slot
    stream = torch.repeat_interleave(                        # (half,)
        torch.arange(len(sections), device=dev),
        torch.tensor(sections, device=dev), output_size=half)
    pos = positions.float().permute(1, 2, 0)[..., stream]     # (B,S,half)
    ang = pos * inv_freq
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, hd); cos/sin: (B, S, hd//2). Half-split rotation."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[:, :, None, :].to(x1.dtype)
    s = sin[:, :, None, :].to(x1.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def text_positions(batch: int, seq: int, offset=0,
                   device=None) -> torch.Tensor:
    """(B, S) int32 positions ``offset, offset + 1, ...`` in every row."""
    p = torch.arange(seq, dtype=torch.int32, device=device)[None, :] + offset
    return p.expand(batch, seq)


def vlm_positions(batch: int, n_vis: int, n_text: int,
                  grid: Optional[Tuple[int, int]] = None,
                  device=None) -> torch.Tensor:
    """(3, B, S) M-RoPE positions (the Qwen2-VL scheme): vision tokens
    get (t=0, h, w) on a ``grid`` (default: sqrt(n_vis) rows, so 256
    patches give 16 x 16), text tokens one sequential position in all
    three streams, starting at max(gh, gw)."""
    if grid is None:
        side = max(int(math.sqrt(n_vis)), 1)
        grid = (side, max(n_vis // side, 1))
    gh, gw = grid
    idx = torch.arange(n_vis, dtype=torch.int32, device=device)
    vt = torch.zeros_like(idx)
    vh = (idx // gw) % gh
    vw = idx % gw
    tpos = torch.arange(n_text, dtype=torch.int32,
                        device=device) + max(gh, gw)
    pos3 = torch.stack([torch.cat([vt, tpos]), torch.cat([vh, tpos]),
                        torch.cat([vw, tpos])])                # (3, S)
    return pos3[:, None, :].expand(3, batch, n_vis + n_text)


# ---------------------------------------------------------------------------
# Attention core (the plain reference)
# ---------------------------------------------------------------------------


def model_backend(cfg) -> str:
    """The kernel backend a config asks for (``reference`` when absent,
    e.g. hand-built test configs)."""
    return getattr(cfg, "kernel_backend", None) or "reference"


def _flash_eligible(q, k, v, q_offset, kv_valid_len) -> bool:
    """Whether this ``attend`` call fits the flash kernel's contract: no
    ragged-cache masking, zero query offset (prefill/train), square q/k
    lengths, matching qk/v head dims and whole GQA groups."""
    return (kv_valid_len is None
            and isinstance(q_offset, int) and q_offset == 0
            and q.shape[1] == k.shape[1]
            and v.shape[-1] == q.shape[-1]
            and q.shape[2] % k.shape[2] == 0)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool = True,
           window: Optional[int] = None,
           q_offset: int = 0,
           kv_valid_len: Optional[torch.Tensor] = None,
           scale: Optional[float] = None,
           backend: str = "reference") -> torch.Tensor:
    """Grouped-query attention with optional sliding window and KV cache
    (the JAX package's ``attend``).

    q: (B, Sq, H, hd); k: (B, Sk, Hkv, hd); v: (B, Sk, Hkv, vd).
    ``q_offset`` is the absolute position of q[0]; ``kv_valid_len (B,)``
    masks ragged cache entries. ``backend`` routes eligible calls to the
    ``flash_attention`` kernel (all f32 inside, output in ``q.dtype``).
    The plain math: scores are f32; a fully masked row gives zeros;
    probabilities are cast to ``v.dtype`` before the PV product, so the
    output is (B, Sq, H, vd) in ``v.dtype``.
    """
    b, sq, h, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    rep = h // hkv
    dev = q.device
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    if dispatch.use_kernel(backend, dev) and _flash_eligible(
            q, k, v, q_offset, kv_valid_len):
        return ops.flash_attention(q, k, v, causal=causal, window=window,
                                   scale=scale, backend=backend)
    qg = (q * scale).reshape(b, sq, hkv, rep, hd)
    scores = _einsum("bqkrd,bskd->bkrqs", qg, k).float()  # (B,Hkv,rep,Sq,Sk)

    qpos = torch.arange(sq, device=dev) + q_offset
    kpos = torch.arange(sk, device=dev)
    mask = torch.ones((sq, sk), dtype=torch.bool, device=dev)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= kpos[None, :] > (qpos[:, None] - window)
    if kv_valid_len is not None:
        valid = kpos[None, None, :] < kv_valid_len.reshape(-1, 1, 1)
        mask = mask[None] & valid                            # (B,Sq,Sk)
        scores = torch.where(mask[:, None, None], scores, NEG_INF)
    else:
        scores = torch.where(mask[None, None, None], scores, NEG_INF)

    probs = torch.softmax(scores, dim=-1)
    if window is not None or kv_valid_len is not None:
        # a fully masked row must emit zeros: softmax over all-NEG_INF
        # logits is uniform and would average dead cache slots
        alive = torch.any(mask, dim=-1)                      # (Sq,)|(B,Sq)
        if alive.ndim == 1:
            alive = alive[None]
        probs = torch.where(alive[:, None, None, :, None], probs, 0.0)
    probs = probs.to(v.dtype)
    out = torch.einsum("bkrqs,bskd->bqkrd", probs, v)
    return out.reshape(b, sq, h, v.shape[-1])


# ---------------------------------------------------------------------------
# GQA attention layer
# ---------------------------------------------------------------------------


def _randn(gen: torch.Generator, shape, dtype, std: float) -> torch.Tensor:
    """Normal(0, std²) draws on the generator's device, scaled in place."""
    return torch.randn(shape, generator=gen, dtype=dtype,
                       device=gen.device).mul_(std)


def init_gqa(gen: torch.Generator, cfg, dtype, lead=()) -> dict:
    """GQA projections; ``lead`` prepends stack axes (e.g. ``(L,)``)."""
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dev = gen.device
    sd = 1.0 / math.sqrt(d)
    p = {
        "wq": _randn(gen, (*lead, d, h * hd), dtype, sd),
        "wk": _randn(gen, (*lead, d, hkv * hd), dtype, sd),
        "wv": _randn(gen, (*lead, d, hkv * hd), dtype, sd),
        "wo": _randn(gen, (*lead, h * hd, d), dtype, 1.0 / math.sqrt(h * hd)),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((*lead, h * hd), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((*lead, hkv * hd), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((*lead, hkv * hd), dtype=dtype, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((*lead, hd), dtype=dtype, device=dev)
        p["k_norm"] = torch.ones((*lead, hd), dtype=dtype, device=dev)
    return p


def lora_scaling(lora) -> float:
    """alpha / r, with alpha defaulting to 2r."""
    r = lora["a"].shape[-1]
    return lora.get("alpha", float(2 * r)) / r if isinstance(lora, dict) else 1.0


def _proj(x, w, b=None, lora=None, backend: str = "reference"):
    """x @ w (+ LoRA bypass) (+ bias). LoRA factors are 2-D ``(din, r)``
    or batched per slot ``(B, din, r)``; ``torch.matmul`` broadcasts the
    batched form. Adapters are cast to the activation dtype at use; the
    cast is differentiable, so an f32 adapter gets an f32 gradient.
    ``backend`` routes 2-D adapters to the fused ``lora_matmul`` kernel
    (single-adapter: per-slot stacks keep the plain path)."""
    if lora is not None and lora["a"].dim() == 2 \
            and dispatch.use_kernel(backend, x.device):
        y = ops.lora_matmul(x, w, lora["a"].to(x.dtype),
                            lora["b"].to(x.dtype),
                            scaling=lora_scaling(lora), backend=backend)
        return y if b is None else y + b
    y = _matmul(x, w)
    if lora is not None:
        a = lora["a"].to(x.dtype)
        bb = lora["b"].to(x.dtype)
        y = y + torch.matmul(torch.matmul(x, a), bb) * lora_scaling(lora)
    if b is not None:
        y = y + b
    return y


def gqa_qkv(params: dict, cfg, x: torch.Tensor, cos, sin, lora=None,
            backend: str = "reference"):
    """Project to rotated q, k, v. lora: optional {'wq': {a,b}, 'wv': {a,b}}."""
    b, s, _ = x.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    lq = lora.get("wq") if lora else None
    lv = lora.get("wv") if lora else None
    q = _proj(x, params["wq"], params.get("bq"), lq,
              backend=backend).reshape(b, s, h, hd)
    k = _proj(x, params["wk"], params.get("bk")).reshape(b, s, hkv, hd)
    v = _proj(x, params["wv"], params.get("bv"), lv,
              backend=backend).reshape(b, s, hkv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm"], cfg.norm_eps)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    return q, k, v


def gqa_attention(params: dict, cfg, x: torch.Tensor, cos, sin, *,
                  window=None, lora=None, causal=True) -> torch.Tensor:
    """Whole-sequence GQA (training, prefill): the config's backend picks
    the kernel branches of the projections and of ``attend``."""
    backend = model_backend(cfg)
    q, k, v = gqa_qkv(params, cfg, x, cos, sin, lora=lora, backend=backend)
    out = attend(q, k, v, causal=causal, window=window, backend=backend)
    b, s = q.shape[:2]
    return _matmul(out.reshape(b, s, -1), params["wo"])


def gqa_decode(params: dict, cfg, x: torch.Tensor, cache: dict, pos, cos,
               sin, *, lora=None):
    """Single-token decode against a (ring-buffer) KV cache.

    cache: {'k': (B, C, Hkv, hd), 'v': ...}, written in place at each
    row's own cursor ``pos % C`` — inactive serving lanes write too, as
    in the JAX package. pos: (B,) int32 absolute positions.
    """
    q, k_new, v_new = gqa_qkv(params, cfg, x, cos, sin, lora=lora)
    k, v = cache["k"], cache["v"]
    cap = k.shape[1]
    rows = torch.arange(pos.shape[0], device=pos.device)
    slots = pos % cap
    k[rows, slots] = k_new[:, 0].to(k.dtype)
    v[rows, slots] = v_new[:, 0].to(v.dtype)
    # ring buffer holds the last `cap` tokens -> all slots valid once full
    valid = torch.clamp(pos + 1, max=cap).to(torch.int32)
    fd = dispatch.get_kernel("flash_decode", model_backend(cfg), q.device)
    out = fd(q, k, v, kv_valid_len=valid)
    b, s = x.shape[:2]
    y = _matmul(out.reshape(b, s, -1), params["wo"])
    return y, cache


def init_gqa_cache(cfg, batch: int, capacity: int, dtype, device,
                   lead=()) -> dict:
    hkv, hd = cfg.n_kv_heads, cfg.hd
    shape = (*lead, batch, capacity, hkv, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V3 multi-head latent attention)
# ---------------------------------------------------------------------------


def init_mla(gen: torch.Generator, cfg, dtype, lead=()) -> dict:
    """MLA projections: the query through a ``q_lora_rank`` bottleneck,
    keys and values from a shared ``kv_lora_rank`` latent plus one rotary
    key; ``lead`` prepends stack axes."""
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    qh = m.qk_nope_head_dim + m.qk_rope_head_dim
    dev = gen.device
    sd = 1.0 / math.sqrt(d)
    return {
        "wq_a": _randn(gen, (*lead, d, m.q_lora_rank), dtype, sd),
        "q_norm": torch.ones((*lead, m.q_lora_rank), dtype=dtype, device=dev),
        "wq_b": _randn(gen, (*lead, m.q_lora_rank, h * qh), dtype,
                       1.0 / math.sqrt(m.q_lora_rank)),
        "wkv_a": _randn(gen, (*lead, d, m.kv_lora_rank + m.qk_rope_head_dim),
                        dtype, sd),
        "kv_norm": torch.ones((*lead, m.kv_lora_rank), dtype=dtype,
                              device=dev),
        "wkv_b": _randn(gen, (*lead, m.kv_lora_rank,
                              h * (m.qk_nope_head_dim + m.v_head_dim)),
                        dtype, 1.0 / math.sqrt(m.kv_lora_rank)),
        "wo": _randn(gen, (*lead, h * m.v_head_dim, d), dtype,
                     1.0 / math.sqrt(h * m.v_head_dim)),
    }


def _mla_q(params, cfg, x, cos, sin, lora=None, backend: str = "reference"):
    """(q_nope (B,S,H,nope), q_rope (B,S,H,rope) rotated). ``wq_b``'s
    adapter reaches ``lora_matmul`` through ``_proj`` when a backend
    asks for it (training, prefill); decoding passes none."""
    m = cfg.mla
    b, s, _ = x.shape
    lq = lora.get("wq_b") if lora else None
    qc = rms_norm(_matmul(x, params["wq_a"]), params["q_norm"], cfg.norm_eps)
    q = _proj(qc, params["wq_b"], None, lq, backend=backend)
    q = q.reshape(b, s, cfg.n_heads, m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope, q_rope = torch.split(q, [m.qk_nope_head_dim,
                                     m.qk_rope_head_dim], dim=-1)
    return q_nope, apply_rope(q_rope, cos, sin)


def _mla_ckv(params, cfg, x, cos, sin):
    """(c (B,S,kv_lora_rank) normed, k_rope (B,S,rope) rotated, shared
    by every head)."""
    m = cfg.mla
    ckv = _matmul(x, params["wkv_a"])
    c, k_rope = torch.split(ckv, [m.kv_lora_rank, m.qk_rope_head_dim],
                            dim=-1)
    c = rms_norm(c, params["kv_norm"], cfg.norm_eps)
    return c, apply_rope(k_rope[:, :, None, :], cos, sin)[:, :, 0]


def mla_attention(params: dict, cfg, x: torch.Tensor, cos, sin, *,
                  lora=None, causal=True, window=None) -> torch.Tensor:
    """Whole-sequence MLA (training, prefill), keys and values expanded
    from the latent. v's head dim differs from q/k's, so ``attend``
    keeps it on the plain path (``_flash_eligible``); the backend still
    routes the ``wq_b``/``wkv_b`` adapters to ``lora_matmul``."""
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.n_heads
    backend = model_backend(cfg)
    q_nope, q_rope = _mla_q(params, cfg, x, cos, sin, lora, backend=backend)
    c, k_rope = _mla_ckv(params, cfg, x, cos, sin)
    lkv = lora.get("wkv_b") if lora else None
    kv = _proj(c, params["wkv_b"], None, lkv, backend=backend)
    kv = kv.reshape(b, s, h, m.qk_nope_head_dim + m.v_head_dim)
    k_nope, v = torch.split(kv, [m.qk_nope_head_dim, m.v_head_dim], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        b, s, h, m.qk_rope_head_dim)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    out = attend(q, k, v, causal=causal, window=window,
                 scale=1.0 / math.sqrt(m.qk_nope_head_dim
                                       + m.qk_rope_head_dim),
                 backend=backend)
    return _matmul(out.reshape(b, s, -1), params["wo"])


def mla_decode(params: dict, cfg, x: torch.Tensor, cache: dict, pos, cos,
               sin, *, lora=None):
    """Single-token MLA in the absorbed formulation: the cache holds only
    the latent ``c`` and the shared rotary key, the query's nope part is
    absorbed into the latent through ``wkv_b``'s key half, and the
    attention is one ``flash_decode`` call with q = [q_abs | q_rope]
    (hd = kv_lora_rank + rope), one kv head [c | k_rope] and v = c (vd =
    kv_lora_rank); its output is expanded through ``wkv_b``'s value
    half. cache: {'c': (B, C, rank), 'k_rope': (B, C, rope)}, written in
    place at each row's cursor ``pos % C``. A ``wkv_b`` adapter is
    merged into the weight: 2-D, or per slot ``(B, rank, r)`` for a
    per-slot up-projection."""
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.n_heads
    nope = m.qk_nope_head_dim
    q_nope, q_rope = _mla_q(params, cfg, x, cos, sin, lora)   # (B,1,H,*)
    c_new, k_rope_new = _mla_ckv(params, cfg, x, cos, sin)
    c, kr = cache["c"], cache["k_rope"]
    cap = c.shape[1]
    rows = torch.arange(pos.shape[0], device=pos.device)
    slots = pos % cap
    c[rows, slots] = c_new[:, 0].to(c.dtype)
    kr[rows, slots] = k_rope_new[:, 0].to(kr.dtype)

    wkv_b = params["wkv_b"]
    if lora and "wkv_b" in lora:
        la = lora["wkv_b"]
        wkv_b = wkv_b + torch.matmul(la["a"].to(wkv_b.dtype),
                                     la["b"].to(wkv_b.dtype)) \
            * lora_scaling(la)
    w_uk = wkv_b.reshape(*wkv_b.shape[:-2], m.kv_lora_rank, h,
                         nope + m.v_head_dim)
    w_uk_k, w_uv = w_uk[..., :nope], w_uk[..., nope:]
    if wkv_b.dim() == 3:                      # per slot: (B, rank, H, *)
        q_abs = _einsum("bqhn,brhn->bqhr", q_nope, w_uk_k)
    else:
        q_abs = _einsum("bqhn,rhn->bqhr", q_nope, w_uk_k)   # (B,1,H,rank)
    scale = 1.0 / math.sqrt(nope + m.qk_rope_head_dim)
    valid = torch.clamp(pos + 1, max=cap).to(torch.int32)
    q_full = torch.cat([q_abs, q_rope], dim=-1)         # (B,1,H,rank+rope)
    kv_lat = torch.cat([c, kr], dim=-1)[:, :, None, :]
    v_lat = c[:, :, None, :]                                 # (B,C,1,rank)
    fd = dispatch.get_kernel("flash_decode", model_backend(cfg), x.device)
    ctx = fd(q_full, kv_lat, v_lat, kv_valid_len=valid, scale=scale)
    if wkv_b.dim() == 3:
        out = _einsum("bqhr,brhv->bqhv", ctx, w_uv)
    else:
        out = _einsum("bqhr,rhv->bqhv", ctx, w_uv)           # (B,1,H,v)
    y = _matmul(out.reshape(b, s, -1), params["wo"])
    return y, cache


def init_mla_cache(cfg, batch: int, capacity: int, dtype, device,
                   lead=()) -> dict:
    m = cfg.mla
    return {
        "c": torch.zeros((*lead, batch, capacity, m.kv_lora_rank),
                         dtype=dtype, device=device),
        "k_rope": torch.zeros((*lead, batch, capacity, m.qk_rope_head_dim),
                              dtype=dtype, device=device),
    }


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, dtype,
             lead=()) -> dict:
    si, so = 1.0 / math.sqrt(d_model), 1.0 / math.sqrt(d_ff)
    return {
        "wg": _randn(gen, (*lead, d_model, d_ff), dtype, si),
        "wu": _randn(gen, (*lead, d_model, d_ff), dtype, si),
        "wd": _randn(gen, (*lead, d_ff, d_model), dtype, so),
    }


def mlp(params: dict, x: torch.Tensor) -> torch.Tensor:
    g = torch.nn.functional.silu(_matmul(x, params["wg"]))
    return _matmul(g * _matmul(x, params["wu"]), params["wd"])
