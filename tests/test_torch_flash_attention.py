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

The wrapper's host-side ``plan`` (variant, tiles, ring depth, grid,
shared memory) is pure and is held here at every attention config's
head dim and at the training paths' shapes.

The Hopper kernel runs only on a card: the ``gpu``-marked tests hold it
against the plain version there and skip here.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import dispatch as jdispatch
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.configs import ALL_ARCH_IDS, get_config
from repro_torch.kernels import dispatch, ops, ref
from repro_torch.kernels.flash_attention import (MAX_SMEM,
                                                 flash_attention_bshd, plan,
                                                 reset_counts, smem_bytes)

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
# the wrapper's plan (host side, no card)
# ---------------------------------------------------------------------------

BF16, F32 = torch.bfloat16, torch.float32
#: the training paths' shapes: llama2-7b-proxy and granite-moe-1b-a400m
PATH_SHAPES = [(4, 1024, 32, 32, 128), (4, 1024, 16, 8, 64)]
ATTENTION_ARCHS = [a for a in ALL_ARCH_IDS
                   if get_config(a).attn_kind == "gqa"]


@pytest.mark.parametrize("b,s,h,hkv,d", PATH_SHAPES,
                         ids=["llama", "granite"])
def test_plan_puts_the_training_paths_on_wgmma(b, s, h, hkv, d):
    p = plan(b, s, h, hkv, d, BF16, True, None)
    assert (p.variant, p.block_q, p.block_kv) == ("wgmma", 128, 128)
    assert p.grid == (8, h, b)
    assert p.stages == (3 if d == 128 else 4)
    # 32 KB of q plus 3 x 64 KB of K+V stages at D 128
    assert p.smem == smem_bytes("wgmma", d, p.stages) <= MAX_SMEM
    assert p.tiles == 8 * 9 // 2          # causal: q tile t visits t + 1


@pytest.mark.parametrize("arch", ATTENTION_ARCHS)
def test_plan_puts_every_attention_config_on_wgmma(arch):
    cfg = get_config(arch)
    assert cfg.hd in (64, 128)
    p = plan(1, 4096, cfg.n_heads, cfg.n_kv_heads, cfg.hd, BF16, True,
             None)
    assert p.variant == "wgmma" and p.grid == (32, cfg.n_heads, 1)


@pytest.mark.parametrize("d", [32, 96, 256])
def test_plan_other_bf16_head_dims_run_mma_sync(d):
    p = plan(2, 300, 8, 2, d, BF16, True, None)
    assert (p.variant, p.block_q, p.block_kv, p.stages) \
        == ("mma_sync", 64, 64, 2)
    assert p.grid == (5, 8, 2)


@pytest.mark.parametrize("d", [16, 64, 128, 256])
def test_plan_f32_runs_fma(d):
    p = plan(2, 300, 8, 2, d, F32, True, None)
    assert (p.variant, p.block_q, p.grid) == ("fma_f32", 32, (10, 8, 2))


def test_plan_forced_variants():
    llama = (4, 1024, 32, 32, 128, BF16, True, None)
    old = plan(*llama, variant="mma_sync")
    assert (old.variant, old.grid, old.tiles) \
        == ("mma_sync", (16, 32, 4), 16 * 17 // 2)
    assert plan(*llama, variant="wgmma") == plan(*llama)
    # a non-positive scale leaves the wgmma variant (its running max is
    # taken on the unscaled scores)
    assert plan(*llama, positive_scale=False).variant == "mma_sync"
    for bad in (dict(variant="wgmma", positive_scale=False),
                dict(variant="fma_f32"), dict(variant="tensor")):
        with pytest.raises(ValueError):
            plan(*llama, **bad)
    with pytest.raises(ValueError):
        plan(2, 300, 8, 2, 96, BF16, True, None, variant="wgmma")
    with pytest.raises(ValueError):
        plan(2, 300, 8, 2, 64, F32, True, None, variant="mma_sync")


@pytest.mark.parametrize("s", [1, 100, 127, 128, 129, 1000, 1024, 4097])
@pytest.mark.parametrize("dtype,d", [(BF16, 128), (BF16, 64), (BF16, 96),
                                     (F32, 128)])
def test_plan_grid_covers_every_q_tile(s, dtype, d):
    p = plan(3, s, 4, 2, d, dtype, True, None)
    assert p.grid == (-(-s // p.block_q), 4, 3)
    assert (p.grid[0] - 1) * p.block_q < s <= p.grid[0] * p.block_q


@pytest.mark.parametrize("s,causal,window", [
    (1024, True, None), (1000, True, None), (100, True, None),
    (1024, True, 64), (1024, True, 256), (1000, True, 300),
    (512, False, None), (300, False, 40)])
@pytest.mark.parametrize("dtype,d", [(BF16, 128), (BF16, 96), (F32, 64)])
def test_plan_visits_exactly_the_tiles_with_live_keys(s, causal, window,
                                                      dtype, d):
    """The kernels' loop bounds visit every (q tile, kv tile) pair that
    holds a live (query, key) pair of the mask, and no other."""
    p = plan(1, s, 2, 2, d, dtype, causal, window)
    i = np.arange(s)[:, None]
    j = np.arange(s)[None, :]
    live = np.ones((s, s), bool)
    if causal:
        live &= j <= i
    if window is not None:
        live &= j > i - window
    nq, nk = -(-s // p.block_q), -(-s // p.block_kv)
    pad = np.zeros((nq * p.block_q, nk * p.block_kv), bool)
    pad[:s, :s] = live
    per_tile = pad.reshape(nq, p.block_q, nk, p.block_kv).any(axis=(1, 3))
    assert p.tiles == int(per_tile.sum())


@pytest.mark.parametrize("variant", ["wgmma", "mma_sync", "fma_f32"])
def test_plan_shared_memory_fits_a_block_up_to_d256(variant):
    """Every head dim a variant takes fits the 232,448 bytes a Hopper
    block may use."""
    dtype = F32 if variant == "fma_f32" else BF16
    step = 4 if dtype == F32 else 8
    dims = (64, 128) if variant == "wgmma" else range(step, 257, step)
    for d in dims:
        p = plan(1, 256, 2, 1, d, dtype, True, None, variant=variant)
        assert p.smem == smem_bytes(variant, d, p.stages) <= MAX_SMEM \
            == 232448


def test_reset_counts_zeroes_launches_and_variants():
    flash_attention_bshd.launches = 5
    flash_attention_bshd.variants["wgmma"] += 3
    reset_counts()
    assert flash_attention_bshd.launches == 0
    assert dict(flash_attention_bshd.variants) == {}
    assert flash_attention_bshd.variants["wgmma"] == 0


# ---------------------------------------------------------------------------
# the Hopper kernel (needs the card)
# ---------------------------------------------------------------------------


def _row_scaled_err(got, want):
    """max over (b, s, h) rows of max|got - want| / max|want|."""
    diff = (got.float() - want.float()).abs().amax(-1)
    return float((diff / want.float().abs().amax(-1)).max())


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the Hopper kernel has no CPU mode)")


#: row-scaled limits: f32 1e-4 (summation order only); bf16 2**-5: the
#: kernel rounds the probabilities to bf16 for the PV product (the plain
#: version keeps them f32) and both round the output, a few bf16 ulps of
#: the row's size at most
ROW_LIMIT = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -5}


def _check_on_card(q, k, v, variant, **kw):
    """One call through the op against the plain version; the call ran
    ``variant``."""
    reset_counts()
    got = ops.flash_attention(q, k, v, **kw)
    want = ref.attention_bshd_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    assert dict(flash_attention_bshd.variants) == {variant: 1}
    assert flash_attention_bshd.launches == 1
    assert got.dtype == want.dtype and got.shape == want.shape
    assert _row_scaled_err(got, want) <= ROW_LIMIT[q.dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,h,hkv,window,causal", [
    (1024, 8, 8, None, True), (300, 28, 4, None, True),
    (257, 8, 2, 64, True), (200, 4, 4, None, False),
])
def test_hopper_kernel_matches_plain_version(d, dtype, s, h, hkv, window,
                                             causal):
    """bf16 at D 64 and 128 runs the wgmma variant, f32 the FMA one."""
    _needs_card()
    _, tx = _operands(("gpu", dtype, s, h, hkv, d), 2, s, h, hkv, d, dtype)
    q, k, v = (t.cuda() for t in tx)
    _check_on_card(q, k, v, "wgmma" if dtype == "bfloat16" else "fma_f32",
                   causal=causal, window=window)


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,h,hkv,d,causal,window", [
    (2, 1000, 8, 2, 128, True, None),     # ragged S
    (2, 100, 4, 4, 128, True, None),      # shorter than one tile
    (2, 100, 4, 2, 64, True, None),
    (2, 1024, 8, 8, 128, True, 64),       # window inside a tile
    (2, 1024, 8, 8, 128, True, 256),      # window across tiles
    (2, 1000, 4, 2, 64, True, 300),
    (2, 512, 8, 8, 128, False, None),     # no mask
    (2, 1024, 28, 4, 128, True, None),    # GQA 7:1 (qwen2-7b)
    (2, 1024, 16, 8, 64, True, None),     # GQA 2:1 (granite-moe)
    (1, 1024, 2, 2, 128, True, None),     # fewer blocks than SMs
], ids=["S1000", "S100", "S100-D64", "window64", "window256",
        "window300-D64", "full512", "gqa28-4", "gqa16-8-D64", "B1H2"])
def test_hopper_wgmma_matches_plain_version(b, s, h, hkv, d, causal,
                                            window):
    _needs_card()
    _, tx = _operands(("wgmma", b, s, h, hkv, d, causal, window or 0), b,
                      s, h, hkv, d, "bfloat16")
    q, k, v = (t.cuda() for t in tx)
    _check_on_card(q, k, v, "wgmma", causal=causal, window=window)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 128])
def test_hopper_wgmma_reads_fused_qkv_views(d):
    """q, k and v as strided views of one (B, S, 3H, D) tensor: the
    tensor maps take the head and row strides as they are."""
    _needs_card()
    b, s, h = 2, 700, 8
    rng = np.random.default_rng(np.random.SeedSequence(
        _entropy(("qkv", d))))
    qkv = torch.from_numpy(rng.standard_normal(
        (b, s, 3 * h, d), dtype=np.float32)).to(torch.bfloat16).cuda()
    q, k, v = qkv[:, :, :h], qkv[:, :, h:2 * h], qkv[:, :, 2 * h:]
    assert not q.is_contiguous()
    _check_on_card(q, k, v, "wgmma", causal=True)


@pytest.mark.gpu
@pytest.mark.parametrize("s,d,causal", [(128, 128, True), (120, 128, False),
                                        (64, 64, True)])
def test_hopper_wgmma_identity_v_gives_the_probabilities(s, d, causal):
    """V one-hot per key (S <= D): the output is the probability matrix
    itself, so a wrong layout of the probabilities in the PV product's A
    registers moves mass to the wrong columns."""
    _needs_card()
    _, tx = _operands(("eye", s, d, causal), 2, s, 4, 4, d, "bfloat16")
    q, k = tx[0].cuda(), tx[1].cuda()
    v = torch.zeros((2, s, 4, d), dtype=torch.bfloat16, device="cuda")
    v[:, torch.arange(s), :, torch.arange(s)] = 1.0
    _check_on_card(q, k, v, "wgmma", causal=causal)

