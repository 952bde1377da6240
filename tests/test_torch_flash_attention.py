"""flash_attention of the PyTorch port against the JAX package.

On the CPU the port's ``ops.flash_attention`` runs its plain version
(``ref.attention_bshd_ref``); it is held against the JAX package's
Pallas kernel (interpret mode) and its reference on the same numpy
inputs. Cases mirror ``tests/test_kernels.py``'s flash-attention sweep:
MHA, GQA h/hkv = 2 and 4, MQA, S not a multiple of the block, causal,
sliding window and full attention, f32 and bf16.

Tolerances: f32 1e-5 (rtol = atol): the online softmax of the Pallas
kernel and the plain softmax sum in other orders. bf16 1e-2: every path
computes in f32 and rounds the output to bf16 once, so they differ by at
most one bf16 ulp of outputs of size <= 1 (2**-8 = 3.9e-3).

The autograd Function's backward differentiates the plain version: its
gradients equal autograd through the plain version exactly and
``jax.vjp`` of the JAX op (whose ``custom_vjp`` differentiates the JAX
reference) at 1e-5.

The Hopper kernel runs only on a card: the ``gpu``-marked test holds it
against the plain version there and skips here.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import dispatch as jdispatch
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import dispatch, ops, ref
from repro_torch.kernels.flash_attention import flash_attention_bshd

torch.set_num_threads(1)

TOL = {"float32": 1e-5, "bfloat16": 1e-2}


def _entropy(case):
    return [p if isinstance(p, int) else int.from_bytes(str(p).encode(), "big")
            for p in case]


def _operands(case, b, s, h, hkv, d, dtype):
    """The same numpy draws as JAX arrays and as torch tensors."""
    rng = np.random.default_rng(np.random.SeedSequence(_entropy(case)))
    arrays = [rng.standard_normal(shape, dtype=np.float32)
              for shape in ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, d))]
    jx = [jnp.asarray(a).astype(dtype) for a in arrays]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    return jx, tx


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("s,h,hkv,d", [
    (64, 4, 4, 32),     # MHA
    (96, 4, 2, 32),     # GQA, S not a multiple of the block
    (64, 4, 1, 32),     # GQA h/hkv = 4
    (40, 2, 1, 64),     # MQA, ragged S
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 16),
                                           (False, None)],
                         ids=["causal", "window", "full"])
def test_flash_attention_matches_jax(s, h, hkv, d, dtype, causal, window):
    (jq, jk, jv), (q, k, v) = _operands((s, h, hkv, d, dtype, causal,
                                         window or 0), 2, s, h, hkv, d,
                                        dtype)
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    assert tuple(got.shape) == (2, s, h, d) and got.dtype == q.dtype
    want_ref = jref.attention_bshd_ref(jq, jk, jv, causal=causal,
                                       window=window)
    want_pallas = jops.flash_attention(jq, jk, jv, causal=causal,
                                       window=window, block_q=32,
                                       block_k=32, interpret=True)
    _close(got, want_ref, TOL[dtype])
    _close(got, want_pallas, TOL[dtype])


def test_scale_override():
    (jq, jk, jv), (q, k, v) = _operands(("scale",), 1, 24, 2, 2, 16,
                                        "float32")
    got = ops.flash_attention(q, k, v, causal=True, scale=0.3)
    _close(got, jref.attention_bshd_ref(jq, jk, jv, causal=True, scale=0.3),
           TOL["float32"])


def test_kernel_layout_ref_matches_jax():
    """The (B, H, S, D) plain version the model-layout one wraps."""
    (jq, jk, jv), (q, k, v) = _operands(("bhsd",), 2, 20, 3, 3, 16,
                                        "float32")
    got = ref.flash_attention_ref(q, k, v, causal=True, window=5)
    want = jref.flash_attention_ref(jq, jk, jv, causal=True, window=5)
    _close(got, want, TOL["float32"])


# ---------------------------------------------------------------------------
# the autograd Function
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hkv,causal,window", [(2, True, None), (1, True, 8),
                                               (2, False, None)])
def test_gradients_match_plain_autograd_and_jax_vjp(hkv, causal, window):
    b, s, h, d = 2, 24, 4, 16
    (jq, jk, jv), (q, k, v) = _operands(("grad", hkv, causal, window or 0),
                                        b, s, h, hkv, d, "float32")
    g = np.random.default_rng(7).standard_normal((b, s, h, d)).astype(
        np.float32)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = ops.flash_attention(*leaves, causal=causal, window=window)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g))

    plain = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want_plain = torch.autograd.grad(
        ref.attention_bshd_ref(*plain, causal=causal, window=window), plain,
        torch.from_numpy(g))
    _, vjp = jax.vjp(lambda *a: jops.flash_attention(
        *a, causal=causal, window=window, block_q=8, block_k=8,
        interpret=True), jq, jk, jv)
    want_jax = vjp(jnp.asarray(g))
    for gt, wp, wj in zip(got, want_plain, want_jax):
        assert torch.equal(gt, wp)
        _close(gt, wj, TOL["float32"])


def test_gradient_only_where_needed():
    """Inputs that need no gradient get None (frozen tensors are not
    differentiated)."""
    _, (q, k, v) = _operands(("need",), 1, 8, 2, 2, 8, "float32")
    q.requires_grad_(True)
    out = ops.flash_attention(q, k, v)
    out.sum().backward()
    assert q.grad is not None and k.grad is None and v.grad is None


# ---------------------------------------------------------------------------
# registry resolution by device
# ---------------------------------------------------------------------------


def test_registry_and_contract_mirror_jax():
    assert dispatch.available_kernels()["flash_attention"] == ["pallas",
                                                               "reference"]
    mine = dispatch.kernel_contracts()["flash_attention"]
    theirs = jdispatch.kernel_contracts()["flash_attention"]
    assert (mine.family, mine.out) == (theirs.family, theirs.out) \
        == ("attention", "like:q")


@pytest.mark.parametrize("backend", ["auto", "pallas", "reference"])
def test_cpu_tensors_get_the_plain_version(backend):
    assert dispatch.get_kernel("flash_attention", backend, "cpu") \
        is ref.attention_bshd_ref
    assert not dispatch.use_kernel(backend, "cpu")


def test_cuda_resolution_rule(monkeypatch):
    assert dispatch.get_kernel("flash_attention", "reference", "cuda") \
        is ref.attention_bshd_ref
    assert not dispatch.use_kernel("reference", "cuda")
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda device=None: (9, 0))
    for backend in ("auto", "pallas"):
        assert dispatch.get_kernel("flash_attention", backend, "cuda") \
            is flash_attention_bshd
        assert dispatch.use_kernel(backend, "cuda")
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda device=None: (8, 0))
    with pytest.raises(RuntimeError, match="capability"):
        dispatch.use_kernel("auto", "cuda")


def test_hopper_wrapper_refuses_cpu_tensors():
    _, (q, k, v) = _operands(("cpu",), 1, 8, 2, 2, 16, "float32")
    before = flash_attention_bshd.launches
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_bshd(q, k, v)
    assert flash_attention_bshd.launches == before


# ---------------------------------------------------------------------------
# the Hopper kernel (needs the card)
# ---------------------------------------------------------------------------


def _row_scaled_err(got, want):
    """max over (b, s, h) rows of max|got - want| / max|want|."""
    diff = (got.float() - want.float()).abs().amax(-1)
    return float((diff / want.float().abs().amax(-1)).max())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,h,hkv,window,causal", [
    (1024, 8, 8, None, True), (300, 28, 4, None, True),
    (257, 8, 2, 64, True), (200, 4, 4, None, False),
])
def test_hopper_kernel_matches_plain_version(dtype, s, h, hkv, window,
                                             causal):
    """Row-scaled limits: f32 1e-4 (summation order only); bf16 2**-5:
    the kernel rounds the probabilities to bf16 for the PV product (the
    plain version keeps them f32) and both round the output, a few bf16
    ulps of the row's size at most."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the Hopper kernel has no CPU mode)")
    _, tx = _operands(("gpu", dtype, s, h, hkv), 2, s, h, hkv, 128, dtype)
    q, k, v = (t.cuda() for t in tx)
    before = flash_attention_bshd.launches
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    want = ref.attention_bshd_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention_bshd.launches == before + 1
    assert got.dtype == want.dtype
    limit = 1e-4 if dtype == "float32" else 2.0 ** -5
    assert _row_scaled_err(got, want) <= limit
