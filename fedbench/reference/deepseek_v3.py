"""The plain f32 DeepSeek-V3 (arXiv:2412.19437; hf:deepseek-ai/DeepSeek-V3
``config.json``): its loss over a (sub)model of the leading dense layers
and the MoE layers that follow, with LoRA on MLA's two up-projections.

Written from the published equations, in f32 throughout, importing
nothing of the program (see ``fedbench.reference`` for the contract):

* MLA: q = RMSNorm(x W_qa) W_qb, split per head into a no-position part
  and a rotary part; the latent [c | k_r] = x W_kva, c RMSNorm'd, k_r one
  rotary key every head shares; [k_nope | v] = c W_kvb per head; causal
  softmax attention of [q_nope | rope(q_r)] against [k_nope | rope(k_r)],
  scaled by 1/sqrt(192) times YaRN's mscale², over v; out through W_o.
  Heads run in blocks of ``HEAD_BLOCK`` so one layer's f32 scores stay
  small.
* YaRN: the rotary frequencies of the 64 rope dims blended between theta's
  and theta's over the factor along the linear ramp between the correction
  dims of beta_fast and beta_slow rotations at the original length; the
  half-split pairing the program uses (the published interleaved pairing
  up to a fixed permutation of the rope columns of random weights).
* The router (``noaux_tc``): sigmoid scores over all routed experts;
  selection on the scores plus ``e_score_correction_bias``, inside the
  ``topk_group`` groups (of ``n_group``) whose two best biased scores sum
  highest, lower index first among equals; weights the chosen experts'
  unbiased scores over their sum, times ``routed_scale``; the
  sequence-wise balance loss (eq. 17-20) times its coefficient.
* The expert share: the configuration holds ``n_experts`` experts from
  ``first_expert`` on of the router's ``n_routed``; each adds its SwiGLU
  output, weighted, for the tokens routed to it, and no slot drops; what
  absent experts add is left out, as on each chip of the deployment; the
  shared expert adds for every token, once.

``per_token`` counts MLA's projections, the causal core, the dense MLP,
the router over all experts, the held experts' expected share (top_k x
held / routed experts a token), the shared expert and the head.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from fedbench.reference import model as M

#: heads a block of the attention core
HEAD_BLOCK = 32
#: MLA's frozen matrices, which the float8 control rounds too
MLA_GEMMS = ("wq_a", "wq_b", "wkv_a", "wkv_b")

padded_vocab = M.padded_vocab


def stack_kinds(model: dict) -> Dict[str, str]:
    return {"dense": "mla_mlp", "moe": "mla_moe"}


def execution_order(model: dict, sizes: Dict[str, int]):
    return [(name, i) for name in ("dense", "moe")
            for i in range(sizes.get(name, 0))]


# ---------------------------------------------------------------------------
# positions
# ---------------------------------------------------------------------------

def _mscale(factor: float, m: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * m * math.log(factor) + 1.0


def yarn(s: int, dim: int, theta: float, rs: dict, device):
    """(cos, sin) (s, dim/2) of YaRN's frequencies, and the softmax scale's
    factor mscale(mscale_all_dim)²."""
    n = rs["original_max_position_embeddings"]
    factor = rs["factor"]

    def corr(rot):
        return dim * math.log(n / (rot * 2 * math.pi)) / (2 * math.log(theta))
    lo = max(math.floor(corr(rs["beta_fast"])), 0)
    hi = min(math.ceil(corr(rs["beta_slow"])), dim - 1)
    if lo == hi:
        hi += 0.001
    j = torch.arange(dim // 2, dtype=torch.float32, device=device)
    base = 1.0 / theta ** (2 * j / dim)
    ramp = torch.clamp((j - lo) / (hi - lo), 0.0, 1.0)
    inv = base * (1.0 - ramp) + base / factor * ramp
    ang = torch.arange(s, dtype=torch.float32, device=device)[:, None] * inv
    m = _mscale(factor, rs.get("mscale", 1.0)) \
        / _mscale(factor, rs.get("mscale_all_dim", 0.0))
    return (torch.cos(ang) * m, torch.sin(ang) * m,
            _mscale(factor, rs.get("mscale_all_dim", 0.0)) ** 2)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def mla(p, model, x, cos, sin, factor, lora):
    m = model["mla"]
    b, s, _ = x.shape
    h, eps = model["n_heads"], model["norm_eps"]
    nope, rd, vd = m["qk_nope_head_dim"], m["qk_rope_head_dim"], \
        m["v_head_dim"]
    lq = lora.get("wq_b") if lora else None
    lkv = lora.get("wkv_b") if lora else None
    q = M.proj(M.rms_norm(x @ p["wq_a"], p["q_norm"], eps), p["wq_b"], lq)
    q = q.reshape(b, s, h, nope + rd)
    q = torch.cat([q[..., :nope], M.apply_rope(q[..., nope:], cos, sin)], -1)
    ckv = x @ p["wkv_a"]
    c = M.rms_norm(ckv[..., :m["kv_lora_rank"]], p["kv_norm"], eps)
    k_r = M.apply_rope(ckv[..., None, m["kv_lora_rank"]:], cos, sin)
    kv = M.proj(c, p["wkv_b"], lkv).reshape(b, s, h, nope + vd)
    k = torch.cat([kv[..., :nope], k_r.expand(b, s, h, rd)], -1)
    v = kv[..., nope:]
    scale = factor / math.sqrt(nope + rd)
    mask = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
    outs = []
    for h0 in range(0, h, HEAD_BLOCK):
        hs = slice(h0, h0 + HEAD_BLOCK)
        sc = torch.einsum("bqhd,bkhd->bhqk", q[:, :, hs], k[:, :, hs]) * scale
        pr = torch.softmax(torch.where(mask, sc, M.NEG_INF), dim=-1)
        outs.append(torch.einsum("bhqk,bkhd->bqhd", pr, v[:, :, hs]))
    return torch.cat(outs, dim=2).reshape(b, s, h * vd) @ p["wo"]


def route(p, mo, x):
    """(weights (T, k), experts (T, k), normalised scores (T, N))."""
    n, k = mo["n_routed"], mo["top_k"]
    g, kg = mo["n_group"], mo["topk_group"]
    t = x.shape[0]
    scores = torch.sigmoid(x @ p["router"])
    choice = scores + p["e_score_correction_bias"]
    top2 = torch.sort(choice.reshape(t, g, n // g), dim=-1,
                      descending=True).values[..., :2].sum(-1)
    _, order = torch.sort(top2, dim=-1, descending=True, stable=True)
    kept = torch.zeros((t, g), dtype=torch.bool, device=x.device)
    kept[torch.arange(t, device=x.device)[:, None], order[:, :kg]] = True
    choice = torch.where(kept.repeat_interleave(n // g, dim=1), choice,
                         -math.inf)
    _, idx = torch.sort(choice, dim=-1, descending=True, stable=True)
    idx = idx[:, :k]
    w = scores.gather(1, idx)
    w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
    return w * mo["routed_scale"], idx, scores / scores.sum(-1, keepdim=True)


def moe(p, model, x, b):
    """x (T, d) of b sequences -> (y, the sequence-wise balance loss)."""
    mo = model["moe"]
    n, k, held, lo = (mo["n_routed"], mo["top_k"], mo["n_experts"],
                      mo.get("first_expert", 0))
    t = x.shape[0]
    s = t // b
    w, idx, probs = route(p, mo, x)
    f = torch.zeros((b, n), dtype=torch.float32, device=x.device)
    f.scatter_add_(1, idx.reshape(b, s * k),
                   torch.ones((b, s * k), device=x.device))
    f = f * n / (k * s)
    aux = (f * probs.reshape(b, s, n).mean(1)).sum(-1).mean() \
        * mo["router_aux_coef"]
    y = M.mlp(p["shared"], x)
    for e in range(held):
        hit = idx == lo + e                                       # (T, k)
        tok = torch.nonzero(hit.any(dim=1))[:, 0]
        if tok.numel() == 0:
            continue
        we = (w * hit).sum(dim=1)[tok]
        xs = x[tok]
        out = (F.silu(xs @ p["wg"][e]) * (xs @ p["wu"][e])) @ p["wd"][e]
        y = y.index_add(0, tok, out * we[:, None])
    return y, aux


# ---------------------------------------------------------------------------
# operations
# ---------------------------------------------------------------------------

def per_token(m: dict, sizes: Dict[str, int], s: int, r: int):
    """(forward, backward) operations a token of a sequence of ``s``
    takes through a (sub)model of ``sizes`` layers a stack: frozen
    weights' backward is the input gradient alone, LoRA factors get both,
    causal attention counts half the score matrix, nothing is
    recomputed."""
    d, h = m["d_model"], m["n_heads"]
    a = m["mla"]
    qk = a["qk_nope_head_dim"] + a["qk_rope_head_dim"]
    kvo = h * (a["qk_nope_head_dim"] + a["v_head_dim"])
    frozen = 2 * (d * a["q_lora_rank"] + a["q_lora_rank"] * h * qk
                  + d * (a["kv_lora_rank"] + a["qk_rope_head_dim"])
                  + a["kv_lora_rank"] * kvo + h * a["v_head_dim"] * d)
    lora = 2 * r * (a["q_lora_rank"] + h * qk) \
        + 2 * r * (a["kv_lora_rank"] + kvo)
    core = h * s * (qk + a["v_head_dim"])      # QK^T and PV, causal half
    mo = m["moe"]
    ffn = {"dense": 6 * d * m["d_ff"],
           "moe": 2 * d * mo["n_routed"]
           + mo["top_k"] * mo["n_experts"] / mo["n_routed"]
           * 6 * d * mo["d_ff_expert"]
           + 6 * d * mo["d_ff_expert"] * mo["n_shared_experts"]}
    fwd = bwd = 0.0
    for name in ("dense", "moe"):
        n = sizes.get(name, 0)
        fwd += n * (frozen + ffn[name] + lora + core)
        bwd += n * (frozen + ffn[name] + 2 * lora + 2 * core)
    head = 2 * d * padded_vocab(m)
    return fwd + head, bwd + head


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------

class Model(M.Model):
    """``model.py``'s loss over DeepSeek-V3's blocks: MLA with YaRN, then
    the dense MLP or the shared expert and the held experts' share. Made,
    it turns TF32 off (f32 products in f32 on the card); the benchmark
    makes it inside a block that restores the settings after."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def stack_kinds(self):
        return stack_kinds(self.model)

    def execution_order(self, sizes):
        return execution_order(self.model, sizes)

    def positions(self, s: int, device):
        """(cos, sin, the softmax scale's YaRN factor)."""
        model = self.model
        return yarn(s, model["mla"]["qk_rope_head_dim"], model["rope_theta"],
                    model["rope_scaling"], device)

    def block(self, p, kind, x, pos, lora):
        cos, sin, factor = pos
        if self.quantize:
            p = {**p, "mixer": {k: M.fp8_round(v) if k in MLA_GEMMS else v
                                for k, v in p["mixer"].items()}}
        eps = self.model["norm_eps"]
        x = x + mla(p["mixer"], self.model, M.rms_norm(x, p["ln1"], eps),
                    cos, sin, factor, lora)
        h = M.rms_norm(x, p["ln2"], eps)
        if kind == "mla_moe":
            b, s, d = h.shape
            y, aux = moe(p["ffn"], self.model, h.reshape(b * s, d), b)
            return x + y.reshape(b, s, d), aux
        return x + M.mlp(p["ffn"], h), torch.zeros((), dtype=x.dtype,
                                                   device=x.device)
