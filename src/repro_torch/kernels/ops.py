"""Public kernel entry points in model layout.

Each op resolves through ``repro_torch.kernels.dispatch`` by the device
of its tensors: a CPU tensor runs the plain PyTorch version
(``repro_torch.kernels.ref``), a CUDA tensor launches the Hopper kernel
or raises — there is no fallback to the plain version on the card.

``flash_attention``, ``lora_matmul``, ``moe_expert_ffn`` and
``ssd_scan`` sit on the training path, so each is a
``torch.autograd.Function`` (the JAX
package's ``custom_vjp``): the forward runs the kernel, the backward is
the gradient of the plain version on the saved inputs. The JAX package
has no backward kernel for any of them. One backward product has a
kernel here all the same: ``lora_matmul``'s input gradient, 2·M·N·K
operations as the forward's, runs on the card's tensor cores in bf16
with f32 sums (``lora_matmul.lora_matmul_bwd``) where the call is bf16
on the card (``backward_route``); the bf16 operands make its products
the f32 gradient's own, so only the order of its sums moves. Under a
profiler the forward's kernel call is the span ``kernel.<name>`` and the
backward ``kernel.<name>.backward`` (``repro_torch.analysis.tracing``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.analysis.tracing import span
from repro_torch.kernels import dispatch, ref
from repro_torch.kernels.lora_matmul import lora_matmul_bwd


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 kv_valid_len: torch.Tensor,
                 scale: Optional[float] = None) -> torch.Tensor:
    """q: (B,1,H,hd); k: (B,C,Hkv,hd); v: (B,C,Hkv,vd) cache-resident;
    kv_valid_len (B,) int32 masks each slot's dead cache entries.
    Returns (B,1,H,vd) in ``v.dtype``; a slot with ``valid == 0`` gives
    exact zeros. Inference only (no autograd)."""
    return dispatch.get_kernel("flash_decode", "auto", q.device)(
        q, k, v, kv_valid_len=kv_valid_len, scale=scale)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, backend):
        ctx.save_for_backward(q, k, v)
        ctx.kw = dict(causal=causal, window=window, scale=scale)
        with span("kernel.flash_attention"):
            return dispatch.get_kernel("flash_attention", backend,
                                       q.device)(q, k, v, **ctx.kw)

    @staticmethod
    def backward(ctx, grad_out):
        """Autograd through ``attention_bshd_ref`` on the saved inputs."""
        need = ctx.needs_input_grad[:3]
        with span("kernel.flash_attention.backward"), torch.enable_grad():
            leaves = [t.detach().requires_grad_(n)
                      for t, n in zip(ctx.saved_tensors, need)]
            out = ref.attention_bshd_ref(*leaves, **ctx.kw)
            grads = iter(torch.autograd.grad(
                out, [t for t, n in zip(leaves, need) if n], grad_out))
        return (*(next(grads) if n else None for n in need),
                None, None, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None,
                    backend: str = "auto") -> torch.Tensor:
    """Model layout: q (B,S,H,D); k/v (B,S,Hkv,D). Returns (B,S,H,D) in
    ``q.dtype``."""
    return _FlashAttention.apply(q, k, v, causal, window, scale, backend)


def backward_route(backend, device, dtype) -> Optional[str]:
    """How ``lora_matmul``'s backward runs for a call on ``device`` in
    ``dtype`` under ``backend``: None off the card (the plain f32
    products, counted nowhere); ``"kernel"`` for bf16 where the forward
    took the Hopper kernel (``lora_matmul_bwd`` for dx and dA's g_xa);
    else ``"plain"`` (the plain products, counted in
    ``lora_matmul_bwd.plain``)."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    if dtype == torch.bfloat16 and dispatch.use_kernel(backend, device):
        return "kernel"
    return "plain"


class _LoraMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, a, b, scaling, backend):
        ctx.save_for_backward(x, w, a, b)
        ctx.scaling, ctx.backend = scaling, backend
        with span("kernel.lora_matmul"):
            return dispatch.get_kernel("lora_matmul", backend, x.device)(
                x, w, a, b, scaling=scaling)

    @staticmethod
    def backward(ctx, grad_out):
        """The products autograd through ``lora_matmul_ref`` runs, in f32,
        for the inputs that need a gradient; the forward's x @ W, which no
        gradient needs, is not recomputed. On the ``"kernel"`` route
        (``backward_route``) dx and g_xa come from the Hopper kernel:
        no f32 copy of W or dx, and g's f32 copy only for dW and dB."""
        with span("kernel.lora_matmul.backward"):
            x, w, a, b = ctx.saved_tensors
            need_x, need_w, need_a, need_b = ctx.needs_input_grad[:4]
            route = backward_route(ctx.backend, x.device, x.dtype)
            dx = dw = da = db = None
            if route == "kernel" and (need_x or need_a):
                g2 = grad_out.reshape(-1, w.shape[1])
                dx, g_xa = lora_matmul_bwd(g2, w, a, b, scaling=ctx.scaling,
                                           dx=need_x)
                if need_x:
                    dx = dx.reshape(x.shape)
                if need_w or need_a or need_b:
                    x2 = x.reshape(-1, x.shape[-1]).float()
                if need_w:
                    dw = (x2.t() @ g2.float()).to(w.dtype)
                if need_a:
                    da = (x2.t() @ g_xa).to(a.dtype)
                if need_b:
                    g_lo = g2.float().mul_(ctx.scaling)
                    db = ((x2 @ a.float()).t() @ g_lo).to(b.dtype)
            else:
                if route == "plain":
                    lora_matmul_bwd.plain += 1
                g = grad_out.reshape(-1, w.shape[1]).float()
                a32, b32 = a.float(), b.float()
                g_lo = g * ctx.scaling                      # (M, N)
                if need_w or need_a or need_b:
                    x2 = x.reshape(-1, x.shape[-1]).float()
                if need_x or need_a:
                    g_xa = g_lo @ b32.t()                   # (M, r)
                if need_x:
                    dx = (g @ w.float().t() + g_xa @ a32.t()).to(x.dtype)
                    dx = dx.reshape(x.shape)
                if need_w:
                    dw = (x2.t() @ g).to(w.dtype)
                if need_a:
                    da = (x2.t() @ g_xa).to(a.dtype)
                if need_b:
                    db = ((x2 @ a32).t() @ g_lo).to(b.dtype)
        return dx, dw, da, db, None, None


def lora_matmul(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor, *, scaling: float = 1.0,
                backend: str = "auto") -> torch.Tensor:
    """x: (..., K) any leading dims; w (K,N); a (K,r); b (r,N), one
    dtype. ``scaling`` = alpha/r (``lora_scaling``), a Python float
    passed to the kernel by value. Returns (..., N) in ``x.dtype``."""
    return _LoraMatmul.apply(x, w, a, b, float(scaling), backend)


class _MoeExpertFfn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, buf, wg, wu, wd, fill, backend):
        ctx.save_for_backward(buf, wg, wu, wd, fill)
        with span("kernel.moe_expert_ffn"):
            return dispatch.get_kernel("moe_expert_ffn", backend,
                                       buf.device)(buf, wg, wu, wd,
                                                   fill=fill)

    @staticmethod
    def backward(ctx, grad_out):
        """Autograd through ``moe_expert_ffn_ref`` on the saved inputs,
        for the inputs that need a gradient (on the training path the
        experts are frozen: only ``buf``); none for ``fill``. With a fill
        the cotangent is zeroed past it first: the same gradients as
        through the plain version's own masking, in one pass over it
        instead of a mask in the recompute and another in its backward."""
        *saved, fill = ctx.saved_tensors
        need = ctx.needs_input_grad[:4]
        with span("kernel.moe_expert_ffn.backward"):
            if fill is not None:
                rows = torch.arange(grad_out.shape[1],
                                    device=grad_out.device)
                grad_out = torch.where(
                    (rows[None, :] < fill[:, None])[..., None], grad_out, 0)
            with torch.enable_grad():
                leaves = [t.detach().requires_grad_(n)
                          for t, n in zip(saved, need)]
                out = ref.moe_expert_ffn_ref(*leaves)
                grads = iter(torch.autograd.grad(
                    out, [t for t, n in zip(leaves, need) if n], grad_out))
        return (*(next(grads) if n else None for n in need), None, None)


def moe_expert_ffn(buf: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                   wd: torch.Tensor, *, fill: Optional[torch.Tensor] = None,
                   backend: str = "auto") -> torch.Tensor:
    """buf (E, C, d); wg, wu (E, d, ff); wd (E, ff, d), one dtype.
    ``fill``: None, or (E,) int32 on buf's device; expert e's rows at or
    past ``fill[e]`` give zeros (``moe_block`` passes its counts).
    Returns (E, C, d) in ``buf.dtype``."""
    return _MoeExpertFfn.apply(buf, wg, wu, wd, fill, backend)


class _SsdScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, a, b, c, d, chunk, backend):
        ctx.save_for_backward(x, dt, a, b, c, d)
        ctx.chunk = chunk
        with span("kernel.ssd_scan"):
            return dispatch.get_kernel("ssd_scan", backend, x.device)(
                x, dt, a, b, c, d, chunk=chunk)

    @staticmethod
    def backward(ctx, grad_out):
        """Autograd through ``ssd_scan_bshp_chunked_ref`` at the same
        chunk on the saved inputs (the JAX package's ``_ssd_bwd``); its
        intermediates live only inside this call."""
        need = ctx.needs_input_grad[:6]
        with span("kernel.ssd_scan.backward"), torch.enable_grad():
            leaves = [t.detach().requires_grad_(n)
                      for t, n in zip(ctx.saved_tensors, need)]
            out = ref.ssd_scan_bshp_chunked_ref(*leaves, chunk=ctx.chunk)
            grads = iter(torch.autograd.grad(
                out, [t for t, n in zip(leaves, need) if n], grad_out))
        return (*(next(grads) if n else None for n in need), None, None)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, d: torch.Tensor, *,
             chunk: int = 128, backend: str = "auto") -> torch.Tensor:
    """Model layout: x (B,S,H,P); dt (B,S,H) f32; b/c (B,S,G,N); a/d (H,)
    f32. Returns (B,S,H,P) in ``x.dtype``."""
    return _SsdScan.apply(x, dt, a, b, c, d, int(chunk), backend)
