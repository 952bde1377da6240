"""Mamba-2 block (SSD, state-space duality, arXiv:2405.21060): the JAX
package's ``repro.models.mamba2`` for training, prefill and decoding.

The forward over a sequence has two branches, as in the JAX package:

* the kernel branch (``dispatch.use_kernel``: on the card under
  ``auto``/``pallas``) calls ``ops.ssd_scan``, whose Hopper kernel caps
  the chunk and masks the ragged end of the sequence itself;
* the plain branch runs ``ssd_chunked`` below at chunk ``min(chunk, S)``
  when ``S`` is not a whole number of chunks, the sequence zero-padded.

The two differ for ``S < chunk`` in their rounding only. The in/out
projections go through ``layers._proj``, so their LoRA adapters share
the ``lora_matmul`` kernel and the alpha/r scaling rule.

Decoding is the O(1) recurrent step: ``init_mamba_cache`` holds the
last ``conv_width - 1`` inputs of the causal conv in the model dtype and
the SSM state in f32; ``mamba_decode`` advances both **in place** (the
JAX package returns updated copies). As in the JAX package it stays on
the plain path whatever ``cfg.kernel_backend`` says: its projections
take no backend, so a shared 2-D adapter never reaches ``lora_matmul``
and no kernel runs in a Mamba decode step.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import dispatch, ops
from repro_torch.kernels.common import NEG_INF
from repro_torch.models.layers import _proj, _randn, model_backend, rms_norm


def d_inner(cfg) -> int:
    return cfg.mamba.expand * cfg.d_model


def n_heads(cfg) -> int:
    return d_inner(cfg) // cfg.mamba.head_dim


def conv_dim(cfg) -> int:
    mb = cfg.mamba
    return d_inner(cfg) + 2 * mb.n_groups * mb.d_state


def init_mamba(gen: torch.Generator, cfg, dtype, lead=()) -> dict:
    """The JAX package's leaves, shapes and dtypes (``dt_bias``, ``A_log``
    and ``D`` in f32 beside weights in ``dtype``); ``lead`` prepends
    stack axes."""
    mb = cfg.mamba
    d = cfg.d_model
    din, h, cd = d_inner(cfg), n_heads(cfg), conv_dim(cfg)
    dev = gen.device
    f32 = torch.float32
    a_log = torch.log(torch.linspace(1.0, 16.0, h, dtype=f32, device=dev))
    # in_proj -> [z (din), x (din), B (G*N), C (G*N), dt (H)]
    return {
        "in_proj": _randn(gen, (*lead, d, 2 * din + 2 * mb.n_groups
                                * mb.d_state + h), dtype, 1.0 / math.sqrt(d)),
        "conv_w": _randn(gen, (*lead, mb.conv_width, cd), dtype, 0.1),
        "conv_b": torch.zeros((*lead, cd), dtype=dtype, device=dev),
        "dt_bias": torch.zeros((*lead, h), dtype=f32, device=dev),
        "A_log": a_log.expand(*lead, h).clone(),
        "D": torch.ones((*lead, h), dtype=f32, device=dev),
        "out_norm": torch.ones((*lead, din), dtype=dtype, device=dev),
        "out_proj": _randn(gen, (*lead, din, d), dtype,
                           1.0 / math.sqrt(din)),
    }


def _split_proj(cfg, zxbcdt):
    mb = cfg.mamba
    din, h = d_inner(cfg), n_heads(cfg)
    gn = mb.n_groups * mb.d_state
    return torch.split(zxbcdt, [din, din, gn, gn, h], dim=-1)


def _causal_conv(x, w, b):
    """x: (B, S, C); w: (K, C) depthwise causal conv."""
    k = w.shape[0]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = sum(xp[:, i: i + x.shape[1]] * w[i] for i in range(k))
    return out + b


def ssd_chunked(x, dt, A, B, C, D, chunk: int):
    """Chunked SSD forward, the JAX package's mixed precision: the
    intra-chunk weights ``scores * L`` and ``dt`` cast to ``x.dtype`` for
    the product with ``x``; chunk states and the inter-chunk term in f32.

    x: (b, S, H, P); dt: (b, S, H) (already softplus'd, > 0);
    A: (H,) negative decay rates; B, C: (b, S, G, N); D: (H,).
    Returns y: (b, S, H, P) in ``x.dtype``.
    """
    b, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    assert S % chunk == 0, (S, chunk)
    nc = S // chunk
    rep = H // G

    xr = x.reshape(b, nc, chunk, H, P)
    dtr = dt.reshape(b, nc, chunk, H)
    Br = torch.repeat_interleave(B.reshape(b, nc, chunk, G, N), rep, dim=3)
    Cr = torch.repeat_interleave(C.reshape(b, nc, chunk, G, N), rep, dim=3)

    dA = dtr * A[None, None, None, :]                       # (b,nc,c,H) < 0
    cum = torch.cumsum(dA, dim=2)                           # within-chunk
    # ---- intra-chunk (quadratic) term --------------------------------
    # L[i,j] = exp(cum[i]-cum[j]) for i>=j. The masked (i<j) entries have
    # a POSITIVE diff that can overflow exp and poison the gradient
    # (inf * 0 = NaN): clamp them to NEG_INF before exponentiating.
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]    # (b,nc,c,c,H)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=x.device))[None, None, :, :, None]
    L = torch.exp(torch.where(mask, diff, NEG_INF))
    scores = torch.einsum("bnihd,bnjhd->bnijh", Cr, Br)     # (b,nc,c,c,H)
    y_intra = torch.einsum("bnijh,bnjh,bnjhp->bnihp",
                           (scores * L).to(x.dtype), dtr.to(x.dtype), xr)
    # ---- chunk states -------------------------------------------------
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)       # (b,nc,c,H)
    states = torch.einsum("bnchs,bnch,bnchp->bnhps", Br.float(),
                          dtr * decay_to_end, xr.float())
    # ---- inter-chunk recurrence (a loop over chunks) -------------------
    chunk_decay = torch.exp(torch.sum(dA, dim=2))           # (b,nc,H)
    carry = torch.zeros((b, H, P, N), dtype=torch.float32, device=x.device)
    prev = []
    for i in range(nc):
        prev.append(carry)                                  # state entering i
        carry = carry * chunk_decay[:, i, :, None, None] + states[:, i]
    prev_states = torch.stack(prev, dim=1)                  # (b,nc,H,P,N)
    # ---- inter-chunk output term --------------------------------------
    y_inter = torch.einsum("bnchs,bnhps,bnch->bnchp", Cr.float(),
                           prev_states, torch.exp(cum)).to(x.dtype)
    y = y_intra + y_inter + xr * D[None, None, None, :, None].to(x.dtype)
    return y.reshape(b, S, H, P)


def mamba_forward(params: dict, cfg, u: torch.Tensor, *,
                  lora=None) -> torch.Tensor:
    """Full-sequence forward. u: (B, S, d_model)."""
    mb = cfg.mamba
    din, h = d_inner(cfg), n_heads(cfg)
    gn = mb.n_groups * mb.d_state
    backend = model_backend(cfg)
    proj = _proj(u, params["in_proj"],
                 lora=lora.get("in_proj") if lora else None, backend=backend)
    z, x, B, C, dt = _split_proj(cfg, proj)
    xbc = torch.cat([x, B, C], dim=-1)
    xbc = F.silu(_causal_conv(xbc, params["conv_w"], params["conv_b"]))
    x, B, C = torch.split(xbc, [din, gn, gn], dim=-1)
    b_, S = u.shape[0], u.shape[1]
    x = x.reshape(b_, S, h, mb.head_dim)
    B = B.reshape(b_, S, mb.n_groups, mb.d_state)
    C = C.reshape(b_, S, mb.n_groups, mb.d_state)
    dt_ = F.softplus(dt.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    if dispatch.use_kernel(backend, u.device):
        # the kernel caps the chunk and masks the ragged sequence itself;
        # x, B and C are read in place (strided slices of xbc)
        y = ops.ssd_scan(x, dt_, A, B, C, params["D"], chunk=mb.chunk,
                         backend=backend)
    else:
        # pad the sequence to a chunk multiple
        chunk = min(mb.chunk, S) if S % mb.chunk else mb.chunk
        if S % chunk:
            pad = chunk - S % chunk
            x = F.pad(x, (0, 0, 0, 0, 0, pad))
            B = F.pad(B, (0, 0, 0, 0, 0, pad))
            C = F.pad(C, (0, 0, 0, 0, 0, pad))
            dt_ = F.pad(dt_, (0, 0, 0, pad))
        y = ssd_chunked(x, dt_, A, B, C, params["D"], chunk)[:, :S]
    y = y.reshape(b_, S, din)
    # gated RMSNorm (Mamba-2 norm-before-out_proj)
    y = y * F.silu(z)
    y = rms_norm(y, params["out_norm"], cfg.norm_eps)
    return _proj(y, params["out_proj"],
                 lora=lora.get("out_proj") if lora else None, backend=backend)


def init_mamba_cache(cfg, batch: int, dtype, device, lead=()) -> dict:
    """``conv`` (…, B, conv_width - 1, conv_dim) in ``dtype`` and ``ssm``
    (…, B, H, P, N), always f32; ``lead`` prepends stack axes."""
    mb = cfg.mamba
    return {
        "conv": torch.zeros((*lead, batch, mb.conv_width - 1, conv_dim(cfg)),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((*lead, batch, n_heads(cfg), mb.head_dim,
                            mb.d_state), dtype=torch.float32, device=device),
    }


def mamba_decode(params: dict, cfg, u: torch.Tensor, cache: dict, *,
                 lora=None):
    """Single-token recurrent step. u: (B, 1, d_model). Writes the new
    conv window and SSM state into ``cache``'s own tensors (``copy_``,
    so a view into a stacked cache advances the stack) and returns
    (y (B, 1, d_model), cache). Adapters may be 2-D or per slot
    ``(B, din, r)``; neither reaches a kernel."""
    mb = cfg.mamba
    din, h = d_inner(cfg), n_heads(cfg)
    gn = mb.n_groups * mb.d_state
    proj = _proj(u, params["in_proj"],
                 lora=lora.get("in_proj") if lora else None)
    z, x, B, C, dt = _split_proj(cfg, proj)
    xbc = torch.cat([x, B, C], dim=-1)[:, 0]                 # (B, cd)
    conv = cache["conv"]
    act = torch.promote_types(conv.dtype, xbc.dtype)
    conv_in = torch.cat([conv.to(act), xbc[:, None].to(act)], dim=1)
    conv_out = (conv_in * params["conv_w"][None]).sum(dim=1) + params["conv_b"]
    xbc_t = F.silu(conv_out)                                 # (B, cd)
    x_t, B_t, C_t = torch.split(xbc_t, [din, gn, gn], dim=-1)
    bsz = u.shape[0]
    rep = h // mb.n_groups
    x_t = x_t.reshape(bsz, h, mb.head_dim)
    B_t = torch.repeat_interleave(
        B_t.reshape(bsz, mb.n_groups, mb.d_state), rep, dim=1)   # (B,H,N)
    C_t = torch.repeat_interleave(
        C_t.reshape(bsz, mb.n_groups, mb.d_state), rep, dim=1)
    dt_t = F.softplus(dt[:, 0].float() + params["dt_bias"])      # (B,H)
    A = -torch.exp(params["A_log"])
    dA = torch.exp(dt_t * A[None])
    ssm = cache["ssm"] * dA[:, :, None, None] + torch.einsum(
        "bh,bhp,bhn->bhpn", dt_t, x_t.float(), B_t.float())
    y = torch.einsum("bhpn,bhn->bhp", ssm, C_t.float())
    y = y + x_t.float() * params["D"][None, :, None]
    y = y.reshape(bsz, 1, din).to(u.dtype)
    y = y * F.silu(z)
    y = rms_norm(y, params["out_norm"], cfg.norm_eps)
    out = _proj(y, params["out_proj"],
                lora=lora.get("out_proj") if lora else None)
    # the cache's own dtype: the window promotes to the activations'
    conv.copy_(conv_in[:, 1:])
    cache["ssm"].copy_(ssm)
    return out, cache
