"""moe_expert_ffn of the PyTorch port against the JAX package.

* The plain version (``ref.moe_expert_ffn_ref``: three einsums in the
  input dtype) against JAX ``expert_ffn_reference`` on the same numpy
  inputs, f32 and bf16, aligned and ragged C/d/ff: f32 at 1e-5 (rtol =
  atol; summation order only); bf16 at 2e-2, since gate, up, the SwiGLU
  and the output each round to bf16 in both, and a one-ulp difference in
  a gate (PyTorch's and XLA's CPU dot products sum in another order)
  moves an output of size ~1 by up to an ulp (2**-7).
* The kernel's arithmetic — f32 inside, one rounding at the end, what
  ``csrc/moe_ffn.cu`` computes and what ``chip_smoke.py`` holds it to —
  written as the plain version on f32 copies rounded once, against JAX's
  Pallas kernel in interpret mode at the JAX package's own limits
  (``tests/test_kernels.py``): f32 2e-4; bf16 5e-2 against JAX's bf16
  reference, and 2e-2 against JAX's Pallas kernel (both f32 inside; one
  bf16 rounding each, and the card rounds the hidden too).
* Rows of zeros (empty capacity slots, an empty expert) give exact zeros.
* The autograd Function: gradients for every operand against
  ``jax.grad`` of the reference at 2e-4 (``tests/test_kernels.py``), and
  none for an operand that does not ask.
* A ``gpu``-marked test holds the Hopper kernel against the plain version
  on a card (skipped without one).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.models import moe as JM
from repro_torch.kernels import dispatch, ops, ref
from repro_torch.kernels.moe_ffn import moe_expert_ffn_ecd

torch.set_num_threads(1)

SHAPES = [  # E, C, d, ff
    (4, 16, 32, 64),
    (3, 13, 24, 40),        # ragged everything: JAX pads, the card masks
    (2, 37, 50, 70),
    (2, 128, 128, 256),     # whole JAX blocks (block_c 128, block_f 256)
]


def _operands(shape, dtype, seed=0, zero_rows=False):
    e, c, d, ff = shape
    rng = np.random.default_rng(np.random.SeedSequence((seed, *shape)))
    arrays = [rng.standard_normal((e, c, d), dtype=np.float32),
              rng.standard_normal((e, d, ff), dtype=np.float32) * d ** -0.5,
              rng.standard_normal((e, d, ff), dtype=np.float32) * d ** -0.5,
              rng.standard_normal((e, ff, d), dtype=np.float32) * ff ** -0.5]
    if zero_rows:
        arrays[0][:, c // 2:] = 0.0        # empty capacity slots
        arrays[0][-1] = 0.0                # an empty expert
    jx = [jnp.asarray(a).astype(dtype) for a in arrays]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    return jx, tx


def _kernel_arithmetic(buf, wg, wu, wd):
    """What the Hopper kernel computes: f32 inside, one rounding."""
    return ref.moe_expert_ffn_ref(buf.float(), wg.float(), wu.float(),
                                  wd.float()).to(buf.dtype)


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_matches_jax_reference(shape, dtype):
    jx, tx = _operands(shape, dtype)
    got = ref.moe_expert_ffn_ref(*tx)
    assert tuple(got.shape) == shape[:3] and got.dtype == tx[0].dtype
    _close(got, JM.expert_ffn_reference(*jx),
           2e-2 if dtype == "bfloat16" else 1e-5)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_arithmetic_matches_jax_pallas(shape, dtype):
    jx, tx = _operands(shape, dtype, seed=1)
    got = _kernel_arithmetic(*tx)
    assert got.dtype == tx[0].dtype
    want = jops.moe_expert_ffn(*jx, block_c=8, block_f=128, interpret=True)
    if dtype == "float32":
        _close(got, want, 2e-4)
    else:
        _close(got, want, 2e-2)
        _close(got, JM.expert_ffn_reference(*jx), 5e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_empty_rows_give_exact_zeros(dtype):
    shape = (3, 24, 40, 72)
    jx, tx = _operands(shape, dtype, seed=2, zero_rows=True)
    empty = (tx[0] == 0).all(-1)
    assert bool(empty[-1].all()) and int(empty.sum()) > shape[1]
    for out in (ref.moe_expert_ffn_ref(*tx), _kernel_arithmetic(*tx),
                ops.moe_expert_ffn(*tx)):
        assert bool((out[empty] == 0).all())
        assert bool((out[~empty] != 0).any())
    jout = np.asarray(jops.moe_expert_ffn(*jx, interpret=True), np.float32)
    assert (jout[empty.numpy()] == 0).all()


def test_autograd_function_gradients_match_jax():
    shape = (3, 13, 24, 40)
    jx, tx = _operands(shape, "float32", seed=3)
    rng = np.random.default_rng(7)
    cot = rng.standard_normal(shape[:3], dtype=np.float32)
    _, vjp = jax.vjp(JM.expert_ffn_reference, *jx)
    want = vjp(jnp.asarray(cot))
    leaves = [t.clone().requires_grad_(True) for t in tx]
    out = ops.moe_expert_ffn(*leaves)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(cot))
    for g, w in zip(got, want):
        _close(g, w, 2e-4)
    # frozen experts (the training path): only buf gets a gradient
    buf = tx[0].clone().requires_grad_(True)
    out = ops.moe_expert_ffn(buf, *tx[1:])
    out.backward(torch.from_numpy(cot))
    _close(buf.grad, want[0], 2e-4)
    assert all(t.grad is None for t in tx[1:])


def test_registry_and_wrapper_contract():
    assert dispatch.available_kernels()["moe_expert_ffn"] \
        == ["pallas", "reference"]
    c = dispatch.kernel_contracts()["moe_expert_ffn"]
    assert (c.family, c.out) == ("moe_ffn", "like:buf")
    # the CPU gets the plain version whatever the backend
    for backend in ("auto", "pallas", "reference"):
        assert dispatch.get_kernel("moe_expert_ffn", backend, "cpu") \
            is ref.moe_expert_ffn_ref
    # the Hopper wrapper takes CUDA tensors only, never a CPU fallback
    _, tx = _operands((2, 8, 16, 16), "float32")
    with pytest.raises(ValueError, match="CUDA tensors"):
        moe_expert_ffn_ecd(*tx)
    assert moe_expert_ffn_ecd.launches == 0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(32, 160, 1024, 512), (3, 77, 200, 90),
                                   (2, 130, 72, 136)])
def test_hopper_kernel_matches_plain_version(dtype, shape):
    """Row-scaled limits (max|out - want| / max|want| per output row, rows
    that are not empty): f32 1e-5 (summation order only); bf16 2**-5
    against the plain version, which rounds gate, up and the hidden to
    bf16 where the kernel keeps f32 but for the hidden; empty rows exact
    zeros."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the Hopper kernel has no CPU mode)")
    _, tx = _operands(shape, dtype, seed=4, zero_rows=True)
    buf, wg, wu, wd = (t.cuda() for t in tx)
    before = moe_expert_ffn_ecd.launches
    got = ops.moe_expert_ffn(buf, wg, wu, wd)
    want = ref.moe_expert_ffn_ref(buf, wg, wu, wd)
    torch.cuda.synchronize()
    assert moe_expert_ffn_ecd.launches == before + 1
    live = (buf != 0).any(-1)
    assert bool((got[~live] == 0).all())
    diff = (got.float() - want.float()).abs().amax(-1)[live]
    err = float((diff / want.float().abs().amax(-1)[live]).max())
    assert err <= (1e-5 if dtype == "float32" else 2.0 ** -5)
    with pytest.raises(ValueError, match="one dtype"):
        moe_expert_ffn_ecd(buf, wg.float() if dtype != "float32"
                           else wg.bfloat16(), wu, wd)
    with pytest.raises(ValueError, match="contiguous"):
        moe_expert_ffn_ecd(buf.transpose(1, 2).contiguous().transpose(1, 2),
                           wg, wu, wd)
