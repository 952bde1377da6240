"""The plain f32 model: the loss of a (sub)model with LoRA on its
projections, layer by layer, for GQA attention with a SwiGLU MLP or a
top-k MoE, and Mamba-2 (SSD) mixers in the hybrid order.

A frozen copy of the port's plain arithmetic, in f32 throughout and with
no kernel, cache or batching: RMSNorm, half-split RoPE, causal softmax
attention, the MoE router with its capacity rule (tokens past an
expert's capacity drop, in token-major slot order), the SwiGLU experts,
the causal depthwise conv and the chunked SSD scan, the next-token loss
over the padded vocabulary, and the Switch load-balance loss.

A submodel is a dict ``{stack: groups}``: each of its layers is the DBLF
fusion of a group of the base stack's layers (one layer for a group of
one), worked out in f32 from the base weights when the layer runs and
again in the backward (``torch.utils.checkpoint``), so at most one
layer's f32 weights live at a time. ``quantize`` rounds each frozen
weight matrix to float8 e4m3 with a per-matrix scale first: the
lower-precision control.

``per_token`` counts the floating-point operations of these layers (see
``fedbench.reference`` for the module contract).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

NEG_INF = -1e30
#: frozen matrices a float8 path would multiply in float8
GEMM_LEAVES = frozenset(("wq", "wk", "wv", "wo", "wg", "wu", "wd",
                         "in_proj", "out_proj", "embed", "lm_head"))


# ---------------------------------------------------------------------------
# layout
# ---------------------------------------------------------------------------

def stack_kinds(model: dict) -> Dict[str, str]:
    if model["family"] == "hybrid":
        return {"mamba_mlp": "mamba_mlp", "mamba_moe": "mamba_moe",
                "attn_mlp": "gqa_mlp"}
    if model.get("moe"):
        return {"layers": "gqa_moe"}
    if model["family"] == "ssm":
        return {"layers": "mamba_only"}
    return {"layers": "gqa_mlp"}


def hybrid_order(sizes: Dict[str, int]):
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


def execution_order(model: dict, sizes: Dict[str, int]):
    if model["family"] == "hybrid":
        return hybrid_order(sizes)
    return [(name, i) for name in stack_kinds(model)
            for i in range(sizes.get(name, 0))]


def padded_vocab(model: dict) -> int:
    return -(-model["vocab"] // 128) * 128


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

def fp8_round(w: torch.Tensor) -> torch.Tensor:
    """``w`` through float8 e4m3 and back, one scale per matrix (the last
    two axes), as a float8 GEMM would read it."""
    amax = w.abs().amax(dim=(-2, -1), keepdim=True).clamp(min=1e-12)
    scale = amax / 448.0
    return (w / scale).to(torch.float8_e4m3fn).float() * scale


def fused_layer(stack: dict, group: List[int], beta: float,
                quantize: bool = False) -> dict:
    """Layer ``group`` of a base stack in f32: the anchor plus beta times
    the sum of the members' differences from it (DBLF, Eq. 5)."""
    def fuse(path, leaf):
        a = leaf[group[0]].float()
        if len(group) > 1:
            s = torch.zeros_like(a)
            for j in group:
                s += leaf[j].float()
            a = a + beta * (s - len(group) * a)
        if quantize and path[-1] in GEMM_LEAVES and a.dim() >= 2:
            a = fp8_round(a)
        return a
    return _map(fuse, stack)


def _map(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def rms_norm(x, scale, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) \
        * scale


def rope(s: int, hd: int, theta: float, device):
    half = hd // 2
    inv = 1.0 / theta ** (torch.arange(half, dtype=torch.float32,
                                       device=device) / half)
    ang = torch.arange(s, dtype=torch.float32, device=device)[:, None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c, s = cos[None, :, None, :], sin[None, :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def proj(x, w, lora=None):
    y = x @ w
    if lora is not None:
        scale = 2.0                       # alpha = 2r
        y = y + (x @ lora["a"]) @ lora["b"] * scale
    return y


def attention(p, model, x, cos, sin, lora):
    b, s, _ = x.shape
    h, hkv = model["n_heads"], model["n_kv_heads"]
    hd = model.get("head_dim") or model["d_model"] // h
    lq = lora.get("wq") if lora else None
    lv = lora.get("wv") if lora else None
    q = proj(x, p["wq"], lq).reshape(b, s, h, hd)
    k = proj(x, p["wk"]).reshape(b, s, hkv, hd)
    v = proj(x, p["wv"], lv).reshape(b, s, hkv, hd)
    q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    rep = h // hkv
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    sc = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    mask = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
    sc = torch.where(mask, sc, NEG_INF)
    out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(sc, dim=-1), v)
    return out.reshape(b, s, h * hd) @ p["wo"]


def mlp(p, x):
    return (F.silu(x @ p["wg"]) * (x @ p["wu"])) @ p["wd"]


def moe(p, model, x):
    """x (T, d) -> (y, aux): top-k routing, capacity dropping, SwiGLU
    experts, the weighted combine."""
    m = model["moe"]
    t, d = x.shape
    e, k = m["n_experts"], m["top_k"]
    probs = torch.softmax(x @ p["router"], dim=-1)
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, idx = w[:, :k], idx[:, :k]
    w = w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-9)
    flat = idx.reshape(-1)
    onehot = (flat[:, None] == torch.arange(e, device=x.device)).int()
    aux = e * torch.sum(probs.mean(dim=0) * onehot.sum(0).float()
                        / (t * k)) * m["router_aux_coef"]
    cap = max(8, -(-int(math.ceil(t * k / e * m["capacity_factor"])) // 8)
              * 8)
    pos = (onehot.T.cumsum(dim=1) - 1).gather(0, flat[None])[0]
    keep = pos < cap
    y = torch.zeros_like(x)
    tok = torch.arange(t * k, device=x.device) // k
    wf = w.reshape(-1)
    for ex in range(e):
        sel = torch.nonzero((flat == ex) & keep)[:, 0]
        if sel.numel() == 0:
            continue
        xs = x[tok[sel]]
        out = (F.silu(xs @ p["wg"][ex]) * (xs @ p["wu"][ex])) @ p["wd"][ex]
        y = y.index_add(0, tok[sel], out * wf[sel, None])
    return y, aux


def ssd_chunked(x, dt, A, B, C, D, chunk):
    b, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    nc, rep = S // chunk, H // G
    xr = x.reshape(b, nc, chunk, H, P)
    dtr = dt.reshape(b, nc, chunk, H)
    Br = B.reshape(b, nc, chunk, G, N).repeat_interleave(rep, dim=3)
    Cr = C.reshape(b, nc, chunk, G, N).repeat_interleave(rep, dim=3)
    dA = dtr * A
    cum = torch.cumsum(dA, dim=2)
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    mask = torch.ones((chunk, chunk), dtype=torch.bool,
                      device=x.device).tril()[None, None, :, :, None]
    L = torch.exp(torch.where(mask, diff, NEG_INF))
    scores = torch.einsum("bnihd,bnjhd->bnijh", Cr, Br)
    y = torch.einsum("bnijh,bnjh,bnjhp->bnihp", scores * L, dtr, xr)
    states = torch.einsum("bnchs,bnch,bnchp->bnhps", Br,
                          dtr * torch.exp(cum[:, :, -1:, :] - cum), xr)
    decay = torch.exp(torch.sum(dA, dim=2))
    carry = torch.zeros((b, H, P, N), dtype=x.dtype, device=x.device)
    prev = []
    for i in range(nc):
        prev.append(carry)
        carry = carry * decay[:, i, :, None, None] + states[:, i]
    y = y + torch.einsum("bnchs,bnhps,bnch->bnchp", Cr,
                         torch.stack(prev, dim=1), torch.exp(cum))
    y = y + xr * D[None, None, None, :, None]
    return y.reshape(b, S, H, P)


def mamba(p, model, u, lora):
    mb, d = model["mamba"], model["d_model"]
    din = mb["expand"] * d
    h = din // mb["head_dim"]
    gn = mb["n_groups"] * mb["d_state"]
    zxbcdt = proj(u, p["in_proj"], lora.get("in_proj") if lora else None)
    z, x, B, C, dt = torch.split(zxbcdt, [din, din, gn, gn, h], dim=-1)
    xbc = torch.cat([x, B, C], dim=-1)
    kw = p["conv_w"].shape[0]
    xp = F.pad(xbc, (0, 0, kw - 1, 0))
    conv = sum(xp[:, i:i + u.shape[1]] * p["conv_w"][i] for i in range(kw))
    xbc = F.silu(conv + p["conv_b"])
    x, B, C = torch.split(xbc, [din, gn, gn], dim=-1)
    b, s = u.shape[:2]
    x = x.reshape(b, s, h, mb["head_dim"])
    B = B.reshape(b, s, mb["n_groups"], mb["d_state"])
    C = C.reshape(b, s, mb["n_groups"], mb["d_state"])
    dt = F.softplus(dt + p["dt_bias"])
    chunk = mb["chunk"] if s % mb["chunk"] == 0 else min(mb["chunk"], s)
    pad = -s % chunk
    if pad:
        x, B, C = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (x, B, C))
        dt = F.pad(dt, (0, 0, 0, pad))
    y = ssd_chunked(x, dt, -torch.exp(p["A_log"]), B, C, p["D"],
                    chunk)[:, :s].reshape(b, s, din)
    y = rms_norm(y * F.silu(z), p["out_norm"], model["norm_eps"])
    return proj(y, p["out_proj"], lora.get("out_proj") if lora else None)


def block(p, model, kind, x, cos, sin, lora):
    eps = model["norm_eps"]
    h = rms_norm(x, p["ln1"], eps)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    if kind.startswith("mamba"):
        x = x + mamba(p["mixer"], model, h, lora)
        if kind == "mamba_only":
            return x, zero
    else:
        x = x + attention(p["mixer"], model, h, cos, sin, lora)
    h2 = rms_norm(x, p["ln2"], eps)
    if kind.endswith("moe"):
        b, s, d = h2.shape
        y, aux = moe(p["ffn"], model, h2.reshape(b * s, d))
        return x + y.reshape(b, s, d), aux
    return x + mlp(p["ffn"], h2), zero


# ---------------------------------------------------------------------------
# operations
# ---------------------------------------------------------------------------
# Counted from the shapes: frozen weights get no weight gradient (their
# backward is the input gradient alone, as many operations as their
# forward), LoRA factors get both, only the top-k experts run, causal
# attention counts half the score matrix, the SSD scan its chunked work,
# and nothing is recomputed.

def _attention_flops(m: dict, s: int, r: int):
    d, h, hkv = m["d_model"], m["n_heads"], m["n_kv_heads"]
    hd = m.get("head_dim") or d // h
    frozen = 2 * d * (h * hd + 2 * hkv * hd) + 2 * h * hd * d
    lora = 2 * r * (d + h * hd) + 2 * r * (d + hkv * hd)
    scores = 2 * h * hd * s          # QK^T and PV over the causal half
    return frozen, lora, scores


def _mamba_flops(m: dict, s: int, r: int):
    mb, d = m["mamba"], m["d_model"]
    din = mb["expand"] * d
    h = din // mb["head_dim"]
    gn = mb["n_groups"] * mb["d_state"]
    n_in = 2 * din + 2 * gn + h
    frozen = 2 * d * n_in + 2 * din * d + 2 * mb["conv_width"] * (din + 2 * gn)
    lora = 2 * r * (d + n_in) + 2 * r * (din + d)
    q = min(mb["chunk"], s)
    scan = h * (q * (mb["d_state"] + mb["head_dim"])
                + 4 * mb["head_dim"] * mb["d_state"])
    return frozen, lora, scan


def _ffn_flops(m: dict, kind: str):
    d = m["d_model"]
    if kind.endswith("moe"):
        mo = m["moe"]
        return 2 * d * mo["n_experts"] + mo["top_k"] * 6 * d * mo["d_ff_expert"]
    return 6 * d * m["d_ff"]


def per_token(m: dict, sizes: Dict[str, int], s: int, r: int):
    """(forward, backward) operations a token of a sequence of ``s``
    takes through a (sub)model of ``sizes`` layers per stack."""
    fwd = bwd = 0.0
    for name, kind in stack_kinds(m).items():
        n = sizes.get(name, 0)
        if kind.startswith("mamba"):
            frozen, lora, seq = _mamba_flops(m, s, r)
        else:
            frozen, lora, seq = _attention_flops(m, s, r)
        if kind != "mamba_only":
            frozen += _ffn_flops(m, kind)
        fwd += n * (frozen + lora + seq)
        bwd += n * (frozen + 2 * lora + 2 * seq)
    head = 2 * m["d_model"] * padded_vocab(m)
    return fwd + head, bwd + head


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------

class Model:
    """The f32 reference over the base ``params`` (any dtype) of the
    configuration's ``model`` section. A module with other layers
    subclasses it and overrides ``stack_kinds``, ``execution_order``,
    ``positions`` and ``block``."""

    def __init__(self, model: dict, params: dict, beta: float = 0.1,
                 quantize: bool = False):
        self.model, self.params = model, params
        self.beta, self.quantize = beta, quantize

    def stack_kinds(self) -> Dict[str, str]:
        return stack_kinds(self.model)

    def execution_order(self, sizes: Dict[str, int]):
        return execution_order(self.model, sizes)

    def positions(self, s: int, device):
        """What every block gets for the positions of a sequence of
        ``s``: the RoPE tables (cos, sin)."""
        model = self.model
        hd = model.get("head_dim") or model["d_model"] // model["n_heads"]
        return rope(s, hd, model["rope_theta"], device)

    def block(self, p, kind, x, pos, lora):
        """One layer of ``kind`` with the f32 weights ``p``: (x, aux)."""
        cos, sin = pos
        return block(p, self.model, kind, x, cos, sin, lora)

    def _top(self, name):
        w = self.params[name].float()
        if self.quantize and name in GEMM_LEAVES:
            w = fp8_round(w)
        return w

    def loss(self, sub: Dict[str, List[List[int]]], lora: dict, batch: dict,
             with_aux: bool = True):
        """(loss + aux, loss) of the submodel ``sub`` ({stack: groups})
        with the f32 LoRA tree ``lora`` ({stack: {proj: {a, b}}}, a leading
        axis over the submodel's layers) on ``batch`` (tokens, labels)."""
        model, dev = self.model, self.params["embed"].device
        tokens = torch.as_tensor(batch["tokens"]).to(dev).long()
        labels = torch.as_tensor(batch["labels"]).to(dev).long()
        x = self._top("embed")[tokens]
        pos = self.positions(tokens.shape[1], dev)
        kinds = self.stack_kinds()
        sizes = {name: len(groups) for name, groups in sub.items()}
        aux = torch.zeros((), dtype=torch.float32, device=dev)
        for name, i in self.execution_order(sizes):
            group = sub[name][i]
            lo = None
            if lora and name in lora:
                lo = _map(lambda _, t, i=i: t[i], lora[name])

            def body(xc, lo, name=name, group=group):
                p = fused_layer(self.params["blocks"][name], group,
                                self.beta, self.quantize)
                return self.block(p, kinds[name], xc, pos, lo)
            x, a = checkpoint(body, x, lo, use_reentrant=False)
            aux = aux + a
        x = rms_norm(x, self._top("final_norm"), model["norm_eps"])
        w = self._top("embed").T if model["tie_embeddings"] \
            else self._top("lm_head")
        logp = torch.log_softmax(x @ w, dim=-1)
        nll = -torch.gather(logp, -1, labels.clamp(min=0)[..., None])[..., 0]
        mask = (labels >= 0).float()
        loss = (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
        return (loss + aux if with_aux else loss), loss


def grads(ref: Model, sub, lora: dict, batch: dict):
    """(loss, grads) of the LoRA tree (f32 leaves) at ``batch``."""
    leaves = []

    def req(_, t):
        t = t.detach().clone().requires_grad_(True)
        leaves.append(t)
        return t
    lo = _map(req, lora)
    with torch.enable_grad():
        total, loss = ref.loss(sub, lo, batch)
        gs = torch.autograd.grad(total, leaves, allow_unused=True)
    it = iter([torch.zeros_like(t) if g is None else g
               for t, g in zip(leaves, gs)])
    return float(loss.detach()), _map(lambda _, t: next(it), lo)


def adamw(grad: dict, state: Optional[dict], lora: dict, lr: float,
          b1=0.9, b2=0.999, eps=1e-8):
    """One AdamW step (no weight decay) on f32 trees: (lora', state')."""
    count = (state or {}).get("count", 0) + 1
    mu = _map(lambda p, g: (1 - b1) * g if state is None
              else b1 * _get(state["mu"], p) + (1 - b1) * g, grad)
    nu = _map(lambda p, g: (1 - b2) * g * g if state is None
              else b2 * _get(state["nu"], p) + (1 - b2) * g * g, grad)
    bc1, bc2 = 1 - b1 ** count, 1 - b2 ** count
    new = _map(lambda p, t: t - lr * ((_get(mu, p) / bc1)
                                      / (torch.sqrt(_get(nu, p) / bc2) + eps)),
               lora)
    return new, {"count": count, "mu": mu, "nu": nu}


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree
