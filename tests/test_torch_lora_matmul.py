"""lora_matmul of the PyTorch port against the JAX package.

On the CPU the port's ``ops.lora_matmul`` runs its plain version
(``ref.lora_matmul_ref``: all products in f32, output in x's dtype); it
is held against the JAX package's Pallas kernel (interpret mode) and its
reference on the same numpy inputs. Cases mirror ``tests/test_kernels.py``
's lora sweep: square, ragged M/N/K (the padding path), r in {2, 4, 8,
32} and, as the JAX kernel takes any r whole, 65 and 128; f32 and bf16,
and leading dims.

The Hopper kernel's order of work (x@A once, rounded to bf16; the rank
product scaled by s as the f32 accumulator's start; then + x@W) is
written out in plain PyTorch here and held to the JAX Pallas kernel, and
the wrapper's host-side ``plan`` (variant, r_pad, padding, grids) is held
at every path shape.

Tolerances: f32 1e-5 (rtol = atol; summation order only) against both.
bf16: 1e-2 against the JAX reference (the same all-f32 math, one bf16
rounding of the output); 2e-2 against the Pallas kernel, which also
rounds x@A to bf16 before the rank product (``lora_matmul.py:89``), the
limit ``tests/test_kernels.py`` holds the two JAX versions to.

The autograd Function's backward runs the products autograd through the
plain version runs (without recomputing x@W): its gradients equal
autograd through the plain version exactly and ``jax.vjp`` of the JAX op
at 1e-5; the frozen ``w`` gets none, a ``w`` that asks gets one.
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import dispatch as jdispatch
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import layers as JL
from repro_torch.kernels import dispatch, ops, ref
from repro_torch.kernels.lora_matmul import lora_matmul_fused
from repro_torch.models import layers as PL
from test_torch_lora_bwd_gpu import check_bf16, ordered

# the module (``repro_torch.kernels.lora_matmul`` names the op function)
lm = sys.modules["repro_torch.kernels.lora_matmul"]

torch.set_num_threads(1)


def _operands(case, x_shape, k, n, r, dtype):
    """x, w, a, b as JAX arrays and torch tensors (w, a, b scaled by 0.1
    as in the JAX package's sweep)."""
    parts = [p if isinstance(p, int) else int.from_bytes(str(p).encode(),
                                                         "big")
             for p in case]
    rng = np.random.default_rng(np.random.SeedSequence(parts))
    arrays = [rng.standard_normal(x_shape, dtype=np.float32)] + [
        0.1 * rng.standard_normal(s, dtype=np.float32)
        for s in ((k, n), (k, r), (r, n))]
    jx = [jnp.asarray(a).astype(dtype) for a in arrays]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    return jx, tx


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("m,k,n,r", [
    (64, 64, 64, 8),
    (100, 96, 72, 4),      # ragged everything: the padding path in JAX
    (100, 96, 72, 2),
    (37, 80, 56, 32),
    (128, 256, 128, 32),
    (70, 96, 80, 65),      # ranks above 64: any r, as the JAX kernel
    (64, 128, 96, 128),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lora_matmul_matches_jax(m, k, n, r, dtype):
    (jx, jw, ja, jb), (x, w, a, b) = _operands((m, k, n, r, dtype), (m, k),
                                               k, n, r, dtype)
    got = ops.lora_matmul(x, w, a, b, scaling=2.0)
    assert tuple(got.shape) == (m, n) and got.dtype == x.dtype
    want_ref = jref.lora_matmul_ref(jx, jw, ja, jb, scaling=2.0)
    want_pallas = jops.lora_matmul(jx, jw, ja, jb, scaling=2.0, block_m=32,
                                   block_n=32, block_k=32, interpret=True)
    bf16 = dtype == "bfloat16"
    _close(got, want_ref, 1e-2 if bf16 else 1e-5)
    _close(got, want_pallas, 2e-2 if bf16 else 1e-5)


def test_leading_dims():
    (jx, jw, ja, jb), (x, w, a, b) = _operands(("lead",), (2, 8, 64), 64,
                                               32, 4, "float32")
    got = ops.lora_matmul(x, w, a, b, scaling=0.5)
    assert tuple(got.shape) == (2, 8, 32)
    _close(got, jops.lora_matmul(jx, jw, ja, jb, scaling=0.5, block_m=16,
                                 block_n=16, block_k=32, interpret=True),
           1e-5)


def test_kernel_branch_of_proj_matches_jax_pallas(monkeypatch):
    """``_proj`` with a 2-D adapter through the forced kernel branch
    (``ops.lora_matmul``, the plain version on the CPU) against the JAX
    package's ``_proj`` on its Pallas backend; f32 adapters cast to the
    activation dtype first, bias added after."""
    (jx, jw, ja, jb), (x, w, a, b) = _operands(("proj",), (3, 5, 48), 48,
                                               40, 8, "float32")
    bias = np.linspace(-1, 1, 40).astype(np.float32)
    monkeypatch.setattr(dispatch, "use_kernel", lambda backend, device: True)
    got = PL._proj(x, w, torch.from_numpy(bias), {"a": a, "b": b},
                   backend="pallas")
    want = JL._proj(jx, jw, jnp.asarray(bias), {"a": ja, "b": jb},
                    backend="pallas")
    _close(got, want, 1e-5)


def _kernel_order(x, w, a, b, scaling):
    """The Hopper kernel's order of work in plain PyTorch: xa = x @ a in
    f32, rounded to b's dtype once; the f32 accumulator starts as
    scaling * (xa @ b); x @ w in f32 accumulates onto it; one rounding to
    x's dtype."""
    xa = (x.float() @ a.float()).to(b.dtype).float()
    acc = scaling * (xa @ b.float())
    return (acc + x.float() @ w.float()).to(x.dtype)


@pytest.mark.parametrize("r", [32, 128])
def test_kernel_order_of_work_matches_jax_pallas(r):
    """At the bf16 limit the file holds the kernel branch to (2e-2)."""
    (jx, jw, ja, jb), (x, w, a, b) = _operands(("order", r), (96, 128), 128,
                                               80, r, "bfloat16")
    got = _kernel_order(x, w, a, b, 2.0)
    want = jops.lora_matmul(jx, jw, ja, jb, scaling=2.0, block_m=32,
                            block_n=32, block_k=32, interpret=True)
    _close(got, want, 2e-2)
    _close(got, ref.lora_matmul_ref(x, w, a, b, scaling=2.0).float(), 2e-2)


# ---------------------------------------------------------------------------
# the host-side plan of a Hopper call
# ---------------------------------------------------------------------------

#: (M, K, N) of every lora_matmul call on the training paths (r 32):
#: llama2-7b-proxy's W_q/W_v, granite-moe-1b-a400m's W_q and W_v,
#: mamba2-2.7b's in_proj and out_proj
PATH_SHAPES = [(4096, 4096, 4096), (4096, 1024, 1024), (4096, 1024, 512),
               (4096, 2560, 10576), (4096, 5120, 2560)]


@pytest.mark.parametrize("m,k,n", PATH_SHAPES)
def test_plan_path_shapes_take_the_wgmma_kernel_unpadded(m, k, n):
    p = lm.plan(m, k, n, 32, torch.bfloat16)
    assert p.variant == "wgmma" and not p.padded
    assert (p.k_pad, p.n_pad, p.r_a, p.r_pad) == (k, n, 32, 64)
    assert p.block_n in (128, 256)
    assert p.grid == (-(-m // 128) * -(-n // p.block_n), 1)
    assert p.prepass_grid == (m // 32, 1)


def test_plan_pads_ragged_shapes_to_whole_vectors():
    p = lm.plan(333, 1001, 777, 96, torch.bfloat16)
    assert p.padded and (p.k_pad, p.n_pad, p.r_a, p.r_pad) == (1008, 784,
                                                               96, 128)
    assert p.prepass_grid == (11, 2)
    p = lm.plan(333, 1001, 777, 8, torch.float32)
    assert p.variant == "fma_f32" and not p.padded
    assert (p.k_pad, p.n_pad, p.r_a) == (1001, 777, 8)


@pytest.mark.parametrize("r", [1, 2, 32, 64, 65, 128, 200])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_plan_takes_any_rank(r, dtype):
    p = lm.plan(4096, 4096, 4096, r, dtype)
    assert p.r_pad % 64 == 0 and r <= p.r_pad < r + 64
    assert p.r_a == (-(-r // 8) * 8 if dtype == torch.bfloat16 else r)
    assert p.padded == (dtype == torch.bfloat16 and r % 8 != 0)


@pytest.mark.parametrize("shape", [(0, 4, 4, 2), (4, 4, 4, 0)])
def test_plan_refuses_empty_operands(shape):
    with pytest.raises(ValueError, match="empty"):
        lm.plan(*shape, torch.bfloat16)


def test_pad_operands_zero_pads_exactly():
    """Padding x along K and w/b along N with zeros leaves the product's
    first N columns unchanged."""
    _, (x, w, a, b) = _operands(("pad",), (5, 13), 13, 11, 3, "float32")
    p = lm.plan(5, 13, 11, 3, torch.bfloat16)
    xp, wp, ap, bp = lm.pad_operands(p, x, w, a, b)
    assert xp.shape == (5, 16) and ap.shape == (13, 8)
    assert wp.shape == (13, 16) and bp.shape == (3, 16)
    got = ref.lora_matmul_ref(xp[:, :13], wp, ap[:, :3], bp, scaling=1.5)
    assert torch.equal(got[:, :11],
                       ref.lora_matmul_ref(x, w, a, b, scaling=1.5))
    assert not xp[:, 13:].any() and not ap[:, 3:].any()
    assert not wp[:, 11:].any() and not bp[:, 11:].any()


# ---------------------------------------------------------------------------
# the autograd Function
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("r", [2, 8])
def test_gradients_match_plain_autograd_and_jax_vjp(r):
    (jx, jw, ja, jb), (x, w, a, b) = _operands(("grad", r), (2, 6, 32), 32,
                                               24, r, "float32")
    g = np.random.default_rng(r).standard_normal((2, 6, 24)).astype(
        np.float32)
    leaves = [x.clone().requires_grad_(True), w,
              a.clone().requires_grad_(True), b.clone().requires_grad_(True)]
    out = ops.lora_matmul(*leaves, scaling=1.5)
    got = torch.autograd.grad(out, [leaves[0], leaves[2], leaves[3]],
                              torch.from_numpy(g))
    plain = [t.clone().requires_grad_(True) for t in (x, a, b)]
    want_plain = torch.autograd.grad(
        ref.lora_matmul_ref(plain[0], w, plain[1], plain[2], scaling=1.5),
        plain, torch.from_numpy(g))
    _, vjp = jax.vjp(lambda x_, a_, b_: jops.lora_matmul(
        x_, jw, a_, b_, scaling=1.5, block_m=8, block_n=8, block_k=16,
        interpret=True), jx, ja, jb)
    want_jax = vjp(jnp.asarray(g))
    for gt, wp, wj in zip(got, want_plain, want_jax):
        assert torch.equal(gt, wp)
        _close(gt, wj, 1e-5)


def test_weight_gradient_when_asked():
    """Every input asks for its gradient, x with leading dims."""
    (jx, jw, ja, jb), ops_in = _operands(("grad-w",), (3, 5, 16), 16, 12, 4,
                                         "float32")
    g = np.random.default_rng(4).standard_normal((3, 5, 12)).astype(
        np.float32)
    leaves = [t.clone().requires_grad_(True) for t in ops_in]
    got = torch.autograd.grad(ops.lora_matmul(*leaves, scaling=0.75), leaves,
                              torch.from_numpy(g))
    plain = [t.clone().requires_grad_(True) for t in ops_in]
    want_plain = torch.autograd.grad(
        ref.lora_matmul_ref(*plain, scaling=0.75), plain, torch.from_numpy(g))
    _, vjp = jax.vjp(lambda *t: jops.lora_matmul(
        *t, scaling=0.75, block_m=8, block_n=8, block_k=16, interpret=True),
        jx, jw, ja, jb)
    for gt, wp, wj in zip(got, want_plain, vjp(jnp.asarray(g))):
        assert torch.equal(gt, wp)
        _close(gt, wj, 1e-5)


def test_frozen_weight_gets_no_gradient_and_casts_carry_grads():
    """An f32 adapter cast to bf16 before the op gets an f32 gradient
    (JAX's cotangents take the primal dtypes); the frozen w none."""
    _, (x, w, a, b) = _operands(("cast",), (4, 32), 32, 16, 4, "bfloat16")
    a32 = a.float().requires_grad_(True)
    b32 = b.float().requires_grad_(True)
    out = ops.lora_matmul(x, w, a32.to(x.dtype), b32.to(x.dtype))
    out.float().sum().backward()
    assert a32.grad.dtype == torch.float32 and b32.grad.dtype == torch.float32
    assert w.grad is None and x.grad is None


# ---------------------------------------------------------------------------
# registry resolution by device
# ---------------------------------------------------------------------------


def test_registry_and_contract_mirror_jax():
    assert dispatch.available_kernels()["lora_matmul"] == ["pallas",
                                                           "reference"]
    mine = dispatch.kernel_contracts()["lora_matmul"]
    theirs = jdispatch.kernel_contracts()["lora_matmul"]
    assert (mine.family, mine.out) == (theirs.family, theirs.out) \
        == ("lora", "x@w")


@pytest.mark.parametrize("backend", ["auto", "pallas", "reference"])
def test_cpu_tensors_get_the_plain_version(backend):
    assert dispatch.get_kernel("lora_matmul", backend, "cpu") \
        is ref.lora_matmul_ref


def test_cuda_resolution_rule(monkeypatch):
    assert dispatch.get_kernel("lora_matmul", "reference", "cuda") \
        is ref.lora_matmul_ref
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda device=None: (9, 0))
    for backend in ("auto", "pallas"):
        assert dispatch.get_kernel("lora_matmul", backend, "cuda") \
            is lora_matmul_fused
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda device=None: (8, 0))
    with pytest.raises(RuntimeError, match="capability"):
        dispatch.get_kernel("lora_matmul", "pallas", "cuda")


@pytest.mark.parametrize("r", [2, 65, 128])
def test_hopper_wrapper_refuses_cpu_tensors(r):
    """Any rank passes the wrapper's checks up to the device, which a CPU
    tensor fails."""
    _, (x, w, a, b) = _operands(("cpu", r), (4, 16), 16, 8, r, "float32")
    before = lora_matmul_fused.launches
    with pytest.raises(ValueError, match="CUDA"):
        lora_matmul_fused(x, w, a, b)
    assert lora_matmul_fused.launches == before


def test_hopper_wrapper_refuses_mixed_dtypes():
    _, (x, w, a, b) = _operands(("mixed",), (4, 16), 16, 8, 2, "float32")
    with pytest.raises(ValueError, match="one dtype"):
        lora_matmul_fused(x, w.to(torch.bfloat16), a, b)
    with pytest.raises(ValueError, match="one dtype"):
        lora_matmul_fused(x.half(), w.half(), a.half(), b.half())


def test_decode_path_never_takes_the_kernel_branch(monkeypatch):
    """Serving's ``gqa_qkv`` call passes no backend: ``_proj`` asks the
    predicate with ``reference`` and keeps the plain path."""
    asked = []
    real = dispatch.use_kernel

    def spy(backend, device):
        asked.append(backend)
        return real(backend, device)
    monkeypatch.setattr(dispatch, "use_kernel", spy)
    _, (x, w, a, b) = _operands(("decode",), (2, 1, 16), 16, 8, 2,
                                "float32")
    PL._proj(x, w, None, {"a": a, "b": b})
    assert asked == ["reference"]


# ---------------------------------------------------------------------------
# the input gradient's kernel: plan, route and arithmetic (host side)
# ---------------------------------------------------------------------------

#: (M, K, N) of the backward's calls beyond PATH_SHAPES (r 32): jamba's
#: Mamba in_proj and out_proj at the benchmark's 16 x 512 tokens,
#: deepseek-v3's W_q_b and W_kv_b, whisper-tiny's W_q/W_v (4 x 448)
BWD_SHAPES = PATH_SHAPES + [(8192, 4096, 16544), (8192, 8192, 4096),
                            (8192, 1024, 1024), (8192, 1024, 512),
                            (4096, 1536, 24576), (4096, 512, 32768),
                            (1792, 384, 384)]


@pytest.mark.parametrize("m,k,n", BWD_SHAPES)
def test_plan_bwd_takes_the_wgmma_kernel_where_the_forward_does(m, k, n):
    p = lm.plan_bwd(m, k, n, 32, torch.bfloat16)
    assert p.variant == "wgmma"
    assert p.padded == lm.plan(m, k, n, 32, torch.bfloat16).padded is False
    assert (p.k_pad, p.n_pad, p.r_a, p.r_pad) == (k, n, 32, 64)
    assert p.block_n == 128
    assert p.grid == (-(-m // 128) * -(-k // 128), 1)
    assert p.prepass_grid == (-(-m // 32), 1)


def test_plan_bwd_pads_ragged_shapes_and_takes_bf16_only():
    p = lm.plan_bwd(333, 1001, 777, 96, torch.bfloat16)
    assert p.padded and (p.k_pad, p.n_pad, p.r_a, p.r_pad) == (1008, 784,
                                                               96, 128)
    assert p.prepass_grid == (11, 2) and p.grid == (3 * 8, 1)
    assert not lm.plan_bwd(333, 200, 136, 8, torch.bfloat16).padded
    with pytest.raises(ValueError, match="bf16"):
        lm.plan_bwd(64, 64, 64, 8, torch.float32)
    with pytest.raises(ValueError, match="empty"):
        lm.plan_bwd(0, 64, 64, 8, torch.bfloat16)


def test_pad_bwd_operands_zero_pads_exactly():
    """g, w and b padded along N, a along r: the plain dx and g_xa of the
    padded operands equal the unpadded ones; K is left as it is."""
    _, (x, w, a, b) = _operands(("pad-bwd",), (5, 13), 13, 11, 3, "float32")
    g = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (5, 11)).astype(np.float32))
    p = lm.plan_bwd(5, 13, 11, 3, torch.bfloat16)
    gp, wp, ap, bp = lm.pad_bwd_operands(p, g, w, a, b)
    assert gp.shape == (5, 16) and wp.shape == (13, 16)
    assert ap.shape == (13, 8) and bp.shape == (3, 16)
    assert torch.equal(gp @ bp.t(), g @ b.t())
    assert torch.equal(gp @ wp.t() + (gp @ bp.t()) @ ap[:, :3].t(),
                       g @ w.t() + (g @ b.t()) @ a.t())
    assert not gp[:, 11:].any() and not wp[:, 11:].any()
    assert not bp[:, 11:].any() and not ap[:, 3:].any()


def test_backward_route(monkeypatch):
    """bf16 on a Hopper card under auto/pallas takes the kernel; f32 and
    ``reference`` on the card the plain products; off the card, no route
    (the plain products, counted nowhere)."""
    bf16, f32 = torch.bfloat16, torch.float32
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda device=None: (9, 0))
    for backend in ("auto", "pallas"):
        assert ops.backward_route(backend, "cuda", bf16) == "kernel"
        assert ops.backward_route(backend, "cuda", f32) == "plain"
        assert ops.backward_route(backend, "cpu", bf16) is None
    assert ops.backward_route("reference", "cuda", bf16) == "plain"
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda device=None: (8, 0))
    with pytest.raises(RuntimeError, match="capability"):
        ops.backward_route("auto", "cuda", bf16)


def _split3(v):
    """The kernel's split of f32 ``v`` into three bf16 terms (round to
    nearest even, each from what the ones before it left)."""
    hi = v.to(torch.bfloat16)
    rest = v - hi.float()
    mid = rest.to(torch.bfloat16)
    return hi, mid, (rest - mid.float()).to(torch.bfloat16)


def _kernel_dx(g2, w, a, b, scaling, split=True):
    """The input-gradient kernel's arithmetic in plain PyTorch: g_xa =
    scaling * (g @ b.T) in f32; the f32 accumulator takes the rank product
    of its three bf16 terms (or of g_xa rounded once to bf16, what the
    split avoids), then g @ w.T; one rounding. Returns (dx, g_xa)."""
    g_xa = scaling * (g2.float() @ b.float().t())
    terms = _split3(g_xa) if split else (g_xa.to(torch.bfloat16),)
    acc = sum(t.float() @ a.float().t() for t in terms)
    return (acc + g2.float() @ w.float().t()).to(g2.dtype), g_xa


def test_split_terms_sum_to_every_f32_value_exactly():
    """Exact down to |v| = 2**-110, where the third term, a multiple of
    v's f32 ulp, is still a bf16 value (bf16's least step is 2**-133);
    below, off by less than that step."""
    v = torch.from_numpy(np.random.default_rng(6).standard_normal(
        200_000).astype(np.float32))
    v = torch.cat([v, v * 1e-30, v * 1e30, v * 3e-5,
                   torch.tensor([0.0, -0.0, 1.0, 2.0 ** -110, 2.0 ** -126])])
    hi, mid, lo = _split3(v)
    err = ((hi.double() + mid.double()) + lo.double() - v.double()).abs()
    normal = v.abs() >= 2.0 ** -110
    assert normal.sum() > 790_000 and not err[normal].any()
    assert float(err.max()) < 2.0 ** -133


def test_rank_term_at_f32_precision_keeps_dx_bit_equal():
    """The kernel's arithmetic (three bf16 terms of g_xa) leaves >= 99% of
    dx's bf16 elements bit-equal to the plain f32 backward's and the rest
    one bf16 step away; g_xa rounded once to bf16 does not (B random, s
    not a power of two, so the rank term is as large as g @ w.T)."""
    m, k, n, r, s = 256, 96, 512, 32, 0.7
    rng = np.random.default_rng(7)

    def rand(*shape, std=1.0):
        return torch.from_numpy((std * rng.standard_normal(shape)).astype(
            np.float32)).to(torch.bfloat16)
    g, w = rand(m, n), rand(k, n, std=k ** -0.5)
    a, b = rand(k, r, std=k ** -0.5), rand(r, n, std=r ** -0.5)
    g32 = g.float()
    g_xa = (g32 * s) @ b.float().t()
    want = (g32 @ w.float().t() + g_xa @ a.float().t()).to(g.dtype)
    got, got_xa = _kernel_dx(g, w, a, b, s)
    check_bf16(got, want)
    torch.testing.assert_close(got_xa, g_xa, rtol=1e-5, atol=1e-5)
    once, _ = _kernel_dx(g, w, a, b, s, split=False)
    assert float((ordered(once) == ordered(want)).float().mean()) < 0.95


def _bwd_case(dtype):
    (_, _, _, _), (x, w, a, b) = _operands(("route", dtype), (2, 6, 32), 32,
                                           24, 4, dtype)
    g = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (2, 6, 24)).astype(np.float32)).to(getattr(torch, dtype))
    leaves = [x.clone().requires_grad_(True), w,
              a.clone().requires_grad_(True), b.clone().requires_grad_(True)]
    return leaves, g


def _grads(leaves, g, scaling=1.5):
    out = ops.lora_matmul(*leaves, scaling=scaling)
    return torch.autograd.grad(out, [leaves[0], leaves[2], leaves[3]], g)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_backward_takes_the_kernel_entry_for_bf16_on_the_card(monkeypatch,
                                                              dtype):
    """With the route resolved as on a Hopper card (CPU tensors, so the
    kernel entry is a plain emulation of its arithmetic that counts as the
    wrapper does): bf16 calls the entry once a backward; f32 runs the
    plain products and counts ``plain`` on the entry; dA comes from the
    entry's g_xa, dB stays the plain product; on the CPU itself nothing is
    counted."""
    leaves, g = _bwd_case(dtype)
    plain = _grads(leaves, g)                      # off the card: no route
    lm.reset_counts()
    assert (lm.lora_matmul_bwd.launches, lm.lora_matmul_bwd.plain) == (0, 0)
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda device=None: (9, 0))
    real = ops.backward_route
    monkeypatch.setattr(ops, "backward_route",
                        lambda backend, device, dt: real(backend, "cuda", dt))
    calls = []

    def entry(g2, w, a, b, *, scaling, dx):
        calls.append((tuple(g2.shape), scaling, dx))
        entry.launches += 1
        return _kernel_dx(g2, w, a, b, scaling)
    entry.launches = entry.plain = 0
    monkeypatch.setattr(ops, "lora_matmul_bwd", entry)
    got = _grads(leaves, g)
    counted = (entry.launches, entry.plain)
    assert (lm.lora_matmul_bwd.launches, lm.lora_matmul_bwd.plain) == (0, 0)
    x2 = leaves[0].detach().reshape(-1, 32).float()
    if dtype == "bfloat16":
        assert calls == [((12, 24), 1.5, True)] and counted == (1, 0)
        dx, g_xa = _kernel_dx(g.reshape(12, 24), *leaves[1:], 1.5)
        assert torch.equal(got[0], dx.reshape(2, 6, 32))
        assert torch.equal(got[1], (x2.t() @ g_xa).to(torch.bfloat16))
        assert torch.equal(got[2], plain[2])
    else:
        assert calls == [] and counted == (0, 1)
        for gt, wp in zip(got, plain):
            assert torch.equal(gt, wp)


# ---------------------------------------------------------------------------
# the Hopper kernel (needs the card)
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n,r", [(512, 1024, 768, 32), (333, 200, 136, 8),
                                     (130, 97, 75, 2), (512, 1024, 768, 128),
                                     (256, 2560, 10576, 32)])
def test_hopper_kernel_matches_plain_version(dtype, m, k, n, r):
    """Row-scaled limits (max|out - want| / max|want| per output row):
    f32 1e-5 (summation order only); bf16 2**-6: the kernel rounds x@A
    to bf16 (as the TPU kernel does) and the plain version does not."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the Hopper kernel has no CPU mode)")
    _, tx = _operands(("gpu", dtype, m, k), (m, k), k, n, r, dtype)
    x, w, a, b = (t.cuda() for t in tx)
    before = lora_matmul_fused.launches
    variant = "wgmma" if dtype == "bfloat16" else "fma_f32"
    runs = lora_matmul_fused.variants[variant]
    got = ops.lora_matmul(x, w, a, b, scaling=2.0)
    want = ref.lora_matmul_ref(x, w, a, b, scaling=2.0)
    torch.cuda.synchronize()
    assert lora_matmul_fused.launches == before + 1
    assert lora_matmul_fused.variants[variant] == runs + 1
    diff = (got.float() - want.float()).abs().amax(-1)
    err = float((diff / want.float().abs().amax(-1)).max())
    assert err <= (1e-5 if dtype == "float32" else 2.0 ** -6)
