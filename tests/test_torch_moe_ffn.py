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
* The fill (each expert's live rows): the plain version with it gives the
  same bits as without it where buf is zero past the fill (as
  ``moe_block`` leaves it) and zeros past the fill otherwise; the
  autograd Function's gradients with it equal those without, and it gets
  no gradient itself.
* ``gpu``-marked tests hold the Hopper kernel against the plain version
  on a card (skipped without one): the planned variant at aligned, padded
  and empty-expert shapes, with and without the fill, and the first
  design (``mma_sync``) through ``run_plan``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.models import moe as JM
from repro_torch.kernels import dispatch, ops, ref
from repro_torch.kernels.moe_ffn import moe_expert_ffn_ecd, plan, run_plan

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


def _fill_of(shape, seed):
    """A fill for each expert of ``shape``: one empty expert, one full,
    the rest anywhere in between."""
    e, c = shape[:2]
    rng = np.random.default_rng(seed)
    fill = rng.integers(0, c + 1, size=e)
    fill[0], fill[-1] = 0, c
    return torch.from_numpy(fill).int()


def _zero_past(buf, fill):
    past = torch.arange(buf.shape[1])[None, :] >= fill[:, None]
    return torch.where(past[..., None], 0, buf), past


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_with_fill(shape, dtype):
    _, tx = _operands(shape, dtype, seed=5)
    fill = _fill_of(shape, 5)
    clean, past = _zero_past(tx[0], fill)
    assert bool(past.any()) and bool((~past).any())
    plain = ref.moe_expert_ffn_ref(clean, *tx[1:])
    assert torch.equal(ref.moe_expert_ffn_ref(clean, *tx[1:], fill=fill),
                       plain)
    # values past the fill: zeros there, the live rows unchanged
    dirty = ref.moe_expert_ffn_ref(*tx, fill=fill)
    assert dirty.dtype == tx[0].dtype and dirty.shape == plain.shape
    assert bool((dirty[past] == 0).all())
    assert torch.equal(dirty[~past], plain[~past])
    assert bool((ref.moe_expert_ffn_ref(*tx)[past] != 0).any())
    # the ops entry point passes the fill through on the CPU
    assert torch.equal(ops.moe_expert_ffn(*tx, fill=fill), dirty)


@pytest.mark.parametrize("frozen", [False, True],
                         ids=["every operand", "frozen experts"])
def test_autograd_function_gradients_with_fill(frozen):
    """With the fill, the gradients equal those without it wherever buf
    is zero past the fill (they move nothing there), and the fill, an
    integer tensor, gets none."""
    shape = (3, 13, 24, 40)
    _, tx = _operands(shape, "float32", seed=6)
    fill = _fill_of(shape, 6)
    tx[0], _ = _zero_past(tx[0], fill)
    cot = torch.from_numpy(np.random.default_rng(8).standard_normal(
        shape[:3], dtype=np.float32))
    grads = []
    for f in (None, fill):
        leaves = [t.clone().requires_grad_(not frozen or i == 0)
                  for i, t in enumerate(tx)]
        out = ops.moe_expert_ffn(*leaves, fill=f)
        out.backward(cot)
        grads.append([t.grad for t in leaves])
        assert fill.grad is None and not fill.requires_grad
    for with_fill, without in zip(grads[1], grads[0]):
        if without is None:
            assert with_fill is None
        else:
            assert torch.equal(with_fill, without)
    assert frozen == all(g is None for g in grads[1][1:])


def test_autograd_function_with_fill_over_values_past_it():
    """Where buf holds values past the fill, the Function's gradients are
    those of the plain version with the fill (rows past it contribute
    nothing), bit for bit: zeroing the cotangent there is the plain
    version's own mask differentiated."""
    shape = (3, 13, 24, 40)
    _, tx = _operands(shape, "float32", seed=10)
    fill = _fill_of(shape, 10)
    cot = torch.from_numpy(np.random.default_rng(11).standard_normal(
        shape[:3], dtype=np.float32))
    grads = []
    for fn in (ops.moe_expert_ffn, ref.moe_expert_ffn_ref):
        leaves = [t.clone().requires_grad_(True) for t in tx]
        fn(*leaves, fill=fill).backward(cot)
        grads.append([t.grad for t in leaves])
    for got, want in zip(*grads):
        assert torch.equal(got, want)
    _, past = _zero_past(tx[0], fill)
    assert bool((grads[0][0][past] == 0).all())


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


@pytest.mark.gpu
@pytest.mark.parametrize("case", [
    ("path", (32, 1280, 1024, 512), False),
    ("path fill", (32, 1280, 1024, 512), True),
    ("padded E8", (8, 1000, 1000, 500), True),
    ("padded E3", (3, 77, 1001, 91), False),
    ("one row tile", (3, 77, 200, 96), True),
], ids=lambda c: c[0])
def test_hopper_wgmma_matches_plain_version(case):
    """bf16 through the planned variant (wgmma; padded where d or ff is
    ragged) and through the first design (mma_sync, ``run_plan``), row-
    scaled 2**-5 against the plain version, empty rows (an empty expert,
    rows past each fill) exact zeros; with the fill the same bits as
    without it, and zeros past it even where buf holds values there;
    two calls bit-equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the Hopper kernel has no CPU mode)")
    _, shape, with_fill = case
    _, tx = _operands(shape, "bfloat16", seed=9, zero_rows=True)
    fill = _fill_of(shape, 9)
    tx[0], past = _zero_past(tx[0], fill)
    buf, wg, wu, wd = (t.cuda() for t in tx)
    fill, past = fill.cuda(), past.cuda()
    p = plan(*shape, torch.bfloat16)
    assert p.variant == "wgmma"
    assert p.padded == bool(shape[2] % 8 or shape[3] % 8)
    before = dict(moe_expert_ffn_ecd.variants)
    got = ops.moe_expert_ffn(buf, wg, wu, wd)
    want = ref.moe_expert_ffn_ref(buf, wg, wu, wd)
    old = run_plan(plan(*shape, torch.bfloat16, variant="mma_sync"),
                   buf, wg, wu, wd)
    torch.cuda.synchronize()
    assert moe_expert_ffn_ecd.variants["wgmma"] == before.get("wgmma", 0) + 1
    live = (buf != 0).any(-1)
    for out in (got, old):
        assert bool((out[~live] == 0).all())
        diff = (out.float() - want.float()).abs().amax(-1)[live]
        assert float((diff / want.float().abs().amax(-1)[live]).max()) \
            <= 2.0 ** -5
    assert torch.equal(got, ops.moe_expert_ffn(buf, wg, wu, wd))
    if with_fill:
        assert torch.equal(moe_expert_ffn_ecd(buf, wg, wu, wd, fill=fill),
                           got)
        dirty = buf + torch.randn_like(buf) * past[..., None]
        filled = moe_expert_ffn_ecd(dirty, wg, wu, wd, fill=fill)
        assert bool((filled[past] == 0).all())
        assert torch.equal(filled[~past], got[~past])
        with pytest.raises(ValueError, match="int32"):
            moe_expert_ffn_ecd(buf, wg, wu, wd, fill=fill.long())
