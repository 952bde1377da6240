"""lora_matmul's input-gradient kernel on the card (``gpu``-marked; skips
without one). This file imports no JAX, so it also runs where JAX is not
installed: ``python -m pytest --noconftest -q -m gpu
tests/test_torch_lora_bwd_gpu.py``.

Through ``ops.lora_matmul``'s autograd, bf16 with f32 adapters cast at use
as the model casts them, B random and s = 0.7: the kernel route
(``auto``) against the plain f32 route (``reference``, the same products
as the JAX package's f32 VJP) at the training paths' shapes and a ragged
one. dx and dA: at least 99% of their bf16 elements bit-equal; the rest
one bf16 step away where the sum does not cancel (|value| at least 2**-8
of its row's largest) and nowhere more than a step of the row's largest,
2**-7 of it at most (where it cancels, two f32 orders of one sum differ
by more than a step of the tiny result). dB is the same plain product on both routes: equal.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.lora_matmul import lora_matmul_bwd

torch.set_num_threads(1)

#: (M, K, N, r): llama2-7b-proxy's W_q/W_v, granite-moe-1b-a400m's W_q and
#: W_v, mamba2-2.7b's in_proj and out_proj (the forward's path shapes),
#: and a ragged shape (M, K and N off every tile, r under 64)
CASES = [(4096, 4096, 4096, 32), (4096, 1024, 1024, 32),
         (4096, 1024, 512, 32), (4096, 2560, 10576, 32),
         (4096, 5120, 2560, 32), (333, 200, 136, 8)]


def ordered(t):
    """bf16 bit patterns in sign-magnitude order (+0 and -0 one point):
    neighbouring bf16 values are one apart."""
    i = t.contiguous().view(torch.int16).int()
    return torch.where(i < 0, -(i & 0x7FFF), i)


def check_bf16(got, want):
    """The module docstring's criterion for dx and dA against the plain
    f32 backward (the CPU tests hold the kernel's arithmetic to it too)."""
    got, want = got.to(torch.bfloat16), want.to(torch.bfloat16)
    steps = (ordered(got) - ordered(want)).abs()
    size = want.float().abs().amax(-1, keepdim=True)
    whole = want.float().abs() >= size * 2.0 ** -8
    equal = float((steps == 0).float().mean())
    assert equal >= 0.99, equal
    assert int(steps[whole].max()) <= 1
    assert float(((got.float() - want.float()).abs() / size).max()) \
        <= 2.0 ** -7


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n,r", CASES)
def test_input_gradient_kernel_matches_the_plain_backward(m, k, n, r):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the Hopper kernel has no CPU mode)")
    rng = np.random.default_rng(np.random.SeedSequence((m, k, n, r)))

    def rand(*shape, std=1.0):
        return torch.from_numpy((std * rng.standard_normal(shape)).astype(
            np.float32)).cuda()
    lead = (4, m // 4) if m % 4 == 0 else (m,)
    x = rand(*lead, k).to(torch.bfloat16)
    w = rand(k, n, std=k ** -0.5).to(torch.bfloat16)
    a, b = rand(k, r, std=k ** -0.5), rand(r, n, std=r ** -0.5)
    g = rand(*lead, n, std=1e-3).to(torch.bfloat16)
    grads = {}
    for backend in ("auto", "reference"):
        leaves = [x.clone().requires_grad_(True), a.clone().requires_grad_(
            True), b.clone().requires_grad_(True)]
        before = (lora_matmul_bwd.launches, lora_matmul_bwd.plain)
        out = ops.lora_matmul(leaves[0], w, leaves[1].to(torch.bfloat16),
                              leaves[2].to(torch.bfloat16), scaling=0.7,
                              backend=backend)
        grads[backend] = torch.autograd.grad(out, leaves, g)
        torch.cuda.synchronize()
        after = (lora_matmul_bwd.launches, lora_matmul_bwd.plain)
        kernel = backend == "auto"
        assert after == (before[0] + kernel, before[1] + (not kernel))
    (dx, da, db), (dx_p, da_p, db_p) = grads["auto"], grads["reference"]
    assert dx.dtype == torch.bfloat16 and dx.shape == x.shape
    assert da.dtype == db.dtype == torch.float32
    check_bf16(dx.reshape(-1, k), dx_p.reshape(-1, k))
    check_bf16(da, da_p)
    assert torch.equal(db, db_p)
