"""MLA's training attention on the card (``gpu``-marked; skips without
one). This file imports no JAX, so it also runs where JAX is not
installed: ``python -m pytest --noconftest -q -m gpu
tests/test_torch_mla_flash_gpu.py``.

DeepSeek-V3's MLA at its published widths (d 7168, 128 heads, q/kv
latents 1536/512, nope 128, rope 64, v 128; YaRN), B 2 x S 256, bf16
weights with f32 LoRA on ``wq_b``/``wkv_b``: ``mla_attention`` under
``auto`` pads v to 192 and takes ``flash_attention`` (one launch, variant
``mma_sync`` at D 192, no plain ``attend``); under ``reference`` it runs
the plain path on the unpadded v. Both are held against the same layer in
f32 on the card (TF32 off): the output, and the gradients of x and of the
LoRA factors. Tolerance: the flash path keeps its scores and
probabilities in f32 where the plain bf16 path rounds them to bf16, so
its error from the f32 layer is at most the plain path's (times 1.1 for
the order of sums) and under 2% of the f32 norm (bf16's q, k, v and
projections alone give ~0.5%).
"""
import dataclasses
import math

import pytest
import torch

from repro_torch.configs import RopeScaling, get_config
from repro_torch.kernels.flash_attention import flash_attention_bshd
from repro_torch.models import layers as Lyr
from repro_torch.models import transformer as T

torch.set_num_threads(1)


def _case(dtype, backend, seed=7):
    cfg = dataclasses.replace(
        get_config("deepseek-v3-671b"), kernel_backend=backend,
        rope_scaling=RopeScaling(factor=40, original_max_position_embeddings=
                                 4096, beta_fast=32, beta_slow=1, mscale=1,
                                 mscale_all_dim=1))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    p = Lyr.init_mla(gen, cfg, torch.float32)
    p = {k: v.to(dtype) for k, v in p.items()}
    lora = {n: {"a": torch.randn((din, 32), generator=gen, device="cuda")
                / math.sqrt(din),
                "b": torch.randn((32, dout), generator=gen, device="cuda")
                * 0.02}
            for n, (din, dout) in T._block_lora_targets(cfg, "mla_mlp")
            .items()}
    x = torch.randn((2, 256, cfg.d_model), generator=gen, device="cuda")
    return cfg, p, lora, x.to(dtype)


def _run(cfg, p, lora, x):
    x = x.detach().requires_grad_(True)
    lo = {n: {k: v.detach().requires_grad_(True) for k, v in t.items()}
          for n, t in lora.items()}
    cos, sin = Lyr.rope_cos_sin(Lyr.text_positions(*x.shape[:2],
                                                   device=x.device),
                                T.rope_dim(cfg), cfg.rope_theta,
                                cfg.rope_scaling)
    y = Lyr.mla_attention(p, cfg, x, cos, sin, lora=lo)
    g = torch.randn(y.shape, generator=torch.Generator(device="cuda")
                    .manual_seed(1), device="cuda").to(y.dtype)
    grads = torch.autograd.grad(y, [x] + [lo[n][k] for n in sorted(lo)
                                          for k in ("a", "b")], g)
    return [y.float()] + [t.float() for t in grads]


def _err(got, want):
    return float((got - want).norm() / want.norm())


@pytest.mark.gpu
def test_mla_training_attention_takes_the_flash_kernel():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the Hopper kernel has no CPU mode)")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        want = _run(*_case(torch.float32, "reference"))
        plain = _run(*_case(torch.bfloat16, "reference"))
        launches = flash_attention_bshd.launches
        mma = flash_attention_bshd.variants["mma_sync"]
        flash = _run(*_case(torch.bfloat16, "auto"))
        assert flash_attention_bshd.launches - launches == 1
        assert flash_attention_bshd.variants["mma_sync"] - mma == 1
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    for f, pl, w in zip(flash, plain, want):
        assert _err(f, w) <= max(1.1 * _err(pl, w), 1e-3)
        assert _err(f, w) <= 2e-2
