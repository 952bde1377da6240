"""ssd_scan of the PyTorch port against the JAX package.

The same numpy inputs (from a seed) go through both packages, on the
grid of ``tests/test_kernels.py`` (ragged S 50; G 1, 2 and 4), f32 and
bf16:

* the plain versions ``ssd_scan_ref`` (sequential oracle, kernel layout),
  ``ssd_scan_bshp_ref``, ``ssd_scan_bshp_chunked_ref`` and the model's
  ``ssd_chunked`` against JAX's: f32 at 1e-5 (rtol = atol; summation
  order only). bf16: within one bf16 ulp of each output row's largest
  value (2**-7 of it, the ulp at the top of its binade): both packages
  round at the same points (the oracle once at the end; the chunked
  version its weights, its two terms and their sum), so only an f32
  difference in summation order can flip a rounding (measured: none on
  this grid);
* the ``_SsdScan`` autograd Function (its forward resolves to the
  chunked plain version on CPU tensors) against JAX ``ops.ssd_scan`` in
  interpret mode, at the JAX package's own limits against its oracle
  (1e-3 f32, 5e-2 bf16);
* gradients with respect to all six inputs against JAX's ``custom_vjp``
  at 1e-4 (f32; the backward of both is the chunked plain version);
* strong decays (a = -16, dt near 3: the within-chunk cumulative sum
  reaches about -3000, where exp(cum) is 0 in f32) stay finite, forward
  and backward, and agree with the sequential oracle;
* the registry, the contract and the resolution rules; the Hopper
  wrapper refuses CPU tensors.
* A ``gpu``-marked test holds the Hopper kernel, on the variant its plan
  picks and forced to ``fma``, against the plain version and the oracle
  on a card (skipped without one).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import mamba2 as JMb
from repro_torch.kernels import dispatch, ops, ref
from repro_torch.kernels.ssd_scan import ssd_scan_bshp
from repro_torch.models import mamba2 as PMb

torch.set_num_threads(1)

GRID = [  # S, H, P, N, G, chunk
    (64, 4, 16, 8, 2, 16),
    (64, 2, 32, 16, 1, 32),
    (48, 4, 16, 8, 4, 16),
    (50, 2, 16, 8, 2, 16),   # ragged S: the chunked versions pad
]
IDS = [f"S{s}H{h}P{p}N{n}G{g}c{c}" for s, h, p, n, g, c in GRID]


def _operands(shape, dtype, seed=0, a_scale=None, dt_shift=0.0):
    """Model-layout numpy inputs: x, b, c in ``dtype``; dt, a, d f32.
    Returns (jax arrays, torch tensors)."""
    s, h, p, n, g, _ = shape
    bsz = 2
    rng = np.random.default_rng(np.random.SeedSequence((seed, *shape)))
    x = rng.standard_normal((bsz, s, h, p), dtype=np.float32) * 0.5
    dt = np.log1p(np.exp(rng.standard_normal((bsz, s, h)).astype(np.float32)
                         + dt_shift)).astype(np.float32)
    a = (-np.exp(rng.standard_normal(h) * 0.3) if a_scale is None
         else np.full(h, a_scale)).astype(np.float32)
    b = rng.standard_normal((bsz, s, g, n), dtype=np.float32) * 0.5
    c = rng.standard_normal((bsz, s, g, n), dtype=np.float32) * 0.5
    d = rng.standard_normal(h).astype(np.float32)
    arrays = [x, dt, a, b, c, d]
    low = {0, 3, 4}                          # x, b, c in the working dtype
    jx = [jnp.asarray(v).astype(dtype) if i in low else jnp.asarray(v)
          for i, v in enumerate(arrays)]
    tx = [torch.from_numpy(v).to(getattr(torch, dtype)) if i in low
          else torch.from_numpy(v) for i, v in enumerate(arrays)]
    return jx, tx


def _np(t):
    return (t.detach().float().numpy() if isinstance(t, torch.Tensor)
            else np.asarray(t, np.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _within_ulps(got, want, ulps):
    """|got - want| <= ulps * 2**-7 * max|want| over each output row
    (the last axis)."""
    g, w = _np(got), _np(want)
    size = np.abs(w).max(-1, keepdims=True)
    assert (np.abs(g - w) <= ulps * 2.0 ** -7 * size).all(), \
        float((np.abs(g - w) / np.maximum(size, 1e-30)).max())


def _check(got, want, dtype):
    if dtype == "float32":
        _close(got, want, 1e-5)
    else:
        assert got.dtype == torch.bfloat16
        _within_ulps(got, want, 1)


def _heads_first(jx, tx):
    """Kernel layout (B, H, S, ·) with b/c repeated to H heads."""
    x, dt, a, b, c, d = jx
    rep = x.shape[2] // b.shape[2]
    jk = (jnp.swapaxes(x, 1, 2), jnp.swapaxes(dt, 1, 2), a,
          jnp.repeat(jnp.swapaxes(b, 1, 2), rep, 1),
          jnp.repeat(jnp.swapaxes(c, 1, 2), rep, 1), d)
    x, dt, a, b, c, d = tx
    tk = (x.transpose(1, 2), dt.transpose(1, 2), a,
          torch.repeat_interleave(b.transpose(1, 2), rep, 1),
          torch.repeat_interleave(c.transpose(1, 2), rep, 1), d)
    return jk, tk


@pytest.mark.parametrize("shape", GRID, ids=IDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_versions_match_jax(shape, dtype):
    jx, tx = _operands(shape, dtype)
    chunk = shape[-1]
    jk, tk = _heads_first(jx, tx)
    _check(ref.ssd_scan_ref(*tk), jref.ssd_scan_ref(*jk), dtype)
    _check(ref.ssd_scan_bshp_ref(*tx), jref.ssd_scan_bshp_ref(*jx), dtype)
    got = ref.ssd_scan_bshp_chunked_ref(*tx, chunk=chunk)
    assert got.dtype == tx[0].dtype and got.shape == tx[0].shape
    _check(got, jref.ssd_scan_bshp_chunked_ref(*jx, chunk=chunk), dtype)
    s = shape[0]
    if s % chunk == 0:
        _check(PMb.ssd_chunked(*tx, chunk), JMb.ssd_chunked(*jx, chunk),
               dtype)


@pytest.mark.parametrize("shape", GRID, ids=IDS)
def test_chunked_matches_sequential_oracle(shape):
    _, tx = _operands(shape, "float32", seed=1)
    _close(ref.ssd_scan_bshp_chunked_ref(*tx, chunk=shape[-1]),
           ref.ssd_scan_bshp_ref(*tx), 1e-3)


@pytest.mark.parametrize("shape", GRID, ids=IDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_autograd_function_matches_jax_interpret(shape, dtype):
    jx, tx = _operands(shape, dtype, seed=2)
    chunk = shape[-1]
    got = ops.ssd_scan(*tx, chunk=chunk)
    assert got.dtype == tx[0].dtype and got.shape == tx[0].shape
    want = jops.ssd_scan(*jx, chunk=chunk, interpret=True)
    _close(got, want, 5e-2 if dtype == "bfloat16" else 1e-3)


@pytest.mark.parametrize("shape", GRID[::3], ids=IDS[::3])
def test_gradients_of_all_six_inputs_match_jax(shape):
    jx, tx = _operands(shape, "float32", seed=3)
    chunk = shape[-1]
    cot = np.random.default_rng(9).standard_normal(
        tx[0].shape).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: jops.ssd_scan(*a, chunk=chunk,
                                              interpret=True), *jx)
    want = vjp(jnp.asarray(cot))
    leaves = [t.clone().requires_grad_(True) for t in tx]
    out = ops.ssd_scan(*leaves, chunk=chunk)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(cot))
    for g, w in zip(got, want):
        assert g.shape == tuple(w.shape)
        _close(g, w, 1e-4)
    # an input that asks for no gradient gets none
    x = tx[0].clone().requires_grad_(True)
    ops.ssd_scan(x, *tx[1:], chunk=chunk).backward(torch.from_numpy(cot))
    _close(x.grad, want[0], 1e-4)
    assert all(t.grad is None for t in tx[1:])


def test_strong_decay_stays_finite_and_matches_oracle():
    shape = (128, 4, 16, 8, 2, 64)
    jx, tx = _operands(shape, "float32", seed=4, a_scale=-16.0,
                       dt_shift=3.0)
    x, dt, a, *_ = tx
    cum = torch.cumsum((dt * a).reshape(2, 2, 64, 4), dim=2)
    assert float(cum.min()) < -2000.0 and float(torch.exp(cum).min()) == 0.0
    got = ref.ssd_scan_bshp_chunked_ref(*tx, chunk=64)
    assert bool(torch.isfinite(got).all())
    _close(got, ref.ssd_scan_bshp_ref(*tx), 1e-3)
    _close(got, jref.ssd_scan_bshp_chunked_ref(*jx, chunk=64), 1e-5)
    leaves = [t.clone().requires_grad_(True) for t in tx]
    grads = torch.autograd.grad(ops.ssd_scan(*leaves, chunk=64).sum(),
                                leaves)
    assert all(bool(torch.isfinite(g).all()) for g in grads)


def test_registry_contract_and_resolution(monkeypatch):
    assert dispatch.available_kernels()["ssd_scan"] == ["pallas",
                                                        "reference"]
    c = dispatch.kernel_contracts()["ssd_scan"]
    assert (c.family, c.out) == ("ssd", "like:x")
    from repro.kernels import dispatch as jdispatch
    jc = jdispatch.kernel_contracts()["ssd_scan"]
    assert (jc.family, jc.out) == (c.family, c.out)
    # the CPU gets the plain chunked version whatever the backend
    for backend in ("auto", "pallas", "reference"):
        assert dispatch.get_kernel("ssd_scan", backend, "cpu") \
            is ref.ssd_scan_bshp_chunked_ref
    assert dispatch.get_kernel("ssd_scan", "reference", "cuda") \
        is ref.ssd_scan_bshp_chunked_ref
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda device=None: (9, 0))
    for backend in ("auto", "pallas"):
        assert dispatch.get_kernel("ssd_scan", backend, "cuda") \
            is ssd_scan_bshp
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda device=None: (8, 0))
    with pytest.raises(RuntimeError, match="capability"):
        dispatch.get_kernel("ssd_scan", "auto", "cuda")


def test_hopper_wrapper_refuses_cpu_tensors():
    _, tx = _operands(GRID[0], "float32")
    before = ssd_scan_bshp.launches
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan_bshp(*tx, chunk=16)
    assert ssd_scan_bshp.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["plan", "fma"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1024, 80, 64, 128, 1, 256),
                                   (1000, 64, 64, 128, 8, 256),
                                   (50, 2, 16, 8, 2, 16)])
def test_hopper_kernel_matches_plain_version(dtype, shape, variant):
    """Limits and their reasons as ``chip_smoke.py``'s ``SSD_TOL``: error
    scaled by each (batch, head) slice's largest output, against the
    chunked plain version (f32 1e-3; bf16 2**-5: the plain version
    rounds its weights and terms to bf16 at other points than the
    kernel) and against the f32 sequential oracle (f32 1e-3; bf16 2**-7).
    ``plan``: through the wrapper, on the variant the plan picks (mma for
    bf16 with P and N multiples of 16, else fma); ``fma``: the first
    design forced on the same inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the Hopper kernel has no CPU mode)")
    from repro_torch.kernels.ssd_scan import (aligned, plan, run_plan,
                                              sm_count)
    _, tx = _operands(shape, dtype, seed=5)
    x, dt, a, b, c, d = (t.cuda() for t in tx)
    s, h, p, n, g, chunk = shape
    if variant == "plan":
        want_variant = ("mma" if dtype == "bfloat16" and p % 16 == 0
                        and n % 16 == 0 else "fma")
        before = ssd_scan_bshp.launches
        ssd_scan_bshp.variants.clear()
        got = ops.ssd_scan(x, dt, a, b, c, d, chunk=chunk)
        torch.cuda.synchronize()
        assert ssd_scan_bshp.launches == before + 1
        assert dict(ssd_scan_bshp.variants) == {want_variant: 1}
    else:
        pl = plan(x.shape[0], s, h, p, g, n, chunk, x.dtype,
                  sm_count(x.device), aligned(x, b, c), variant="fma")
        got = run_plan(pl, x, dt, a, b, c, d)
    plain = ref.ssd_scan_bshp_chunked_ref(x, dt, a, b, c, d, chunk=chunk)
    oracle = ref.ssd_scan_bshp_ref(x.float(), dt, a, b.float(), c.float(), d)
    torch.cuda.synchronize()
    for want, tol in ((plain, 1e-3 if dtype == "float32" else 2.0 ** -5),
                      (oracle, 1e-3 if dtype == "float32" else 2.0 ** -7)):
        diff = (got.float() - want.float()).abs().amax(dim=(1, 3))
        size = want.float().abs().amax(dim=(1, 3))
        assert float((diff / size).max()) <= tol
