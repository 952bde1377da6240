"""flash_decode of the PyTorch port against the JAX package.

On the CPU the port's ``ops.flash_decode`` runs its plain version; it is
held against the JAX package's Pallas kernel (interpret mode) and its
reference ``flash_decode_ref`` on the same numpy inputs. Cases mirror
``tests/test_kernels.py``'s flash-decode sweep: MHA, GQA rep 2/4/7,
single head, vd != hd, ragged valid lengths {0, 1, mid, C}, a scale
override, the ring-buffer case (valid == capacity), and f32, bf16 and
f32 q against a bf16 cache.

Tolerances: f32 1e-5 (rtol = atol; different summation order only);
bf16 1e-2 (bf16 rounding of scores, probabilities and outputs happens at
other places in the Pallas kernel and in the two references).

The Hopper kernel itself runs only on a card: ``test_hopper_kernel_
matches_plain_version`` is marked ``gpu`` and skips without one.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import dispatch as jdispatch
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.common import NEG_INF as JAX_NEG_INF
from repro_torch.kernels import dispatch, ops, ref
from repro_torch.kernels.common import NEG_INF
from repro_torch.kernels.flash_decode import TILE, flash_decode_bhrd, split_plan

torch.set_num_threads(1)

TOL = {"f32": 1e-5, "bf16": 1e-2, "f32q-bf16kv": 1e-2}
# (q dtype, cache dtype) for each case
DTYPES = {"f32": ("float32", "float32"), "bf16": ("bfloat16", "bfloat16"),
          "f32q-bf16kv": ("float32", "bfloat16")}


def _entropy(case):
    """SeedSequence entropy from a case key of ints and strings."""
    parts = case if isinstance(case, tuple) else (case,)
    return [p if isinstance(p, int) else int.from_bytes(p.encode(), "big")
            for p in parts]


def _operands(case, b, cap, h, hkv, hd, vd, dtypes, valid):
    """The same numpy draws as JAX arrays and as torch tensors."""
    rng = np.random.default_rng(np.random.SeedSequence(_entropy(case)))
    arrays = [rng.standard_normal(s, dtype=np.float32)
              for s in ((b, 1, h, hd), (b, cap, hkv, hd), (b, cap, hkv, vd))]
    qdt, kvdt = DTYPES[dtypes]
    jx = [jnp.asarray(a).astype(dt)
          for a, dt in zip(arrays, (qdt, kvdt, kvdt))]
    tx = [torch.from_numpy(a).to(getattr(torch, dt))
          for a, dt in zip(arrays, (qdt, kvdt, kvdt))]
    valid = np.asarray(valid, np.int32)
    return jx, tx, jnp.asarray(valid), torch.from_numpy(valid)


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("h,hkv,hd,vd", [
    (4, 4, 32, 32),          # MHA
    (4, 2, 32, 32),          # GQA rep 2
    (4, 1, 32, 32),          # GQA rep 4
    (7, 1, 32, 32),          # GQA rep 7 (qwen2-7b's 28/4, not a power of 2)
    (1, 1, 32, 32),          # single head
    (4, 1, 48, 32),          # absorbed-MLA shape: qk rank+rope, v rank
])
@pytest.mark.parametrize("dtypes", sorted(DTYPES))
def test_flash_decode_matches_jax(h, hkv, hd, vd, dtypes):
    b, cap = 4, 64
    valid = [0, 1, 37, cap]            # empty, single, mid-prefix, full
    (jq, jk, jv), (q, k, v), jvalid, tvalid = _operands(
        (h, hkv, hd, vd, dtypes), b, cap, h, hkv, hd, vd, dtypes, valid)
    got = ops.flash_decode(q, k, v, kv_valid_len=tvalid)
    want_ref = jref.flash_decode_ref(jq, jk, jv, kv_valid_len=jvalid)
    want_pallas = jops.flash_decode(jq, jk, jv, kv_valid_len=jvalid,
                                    interpret=True)
    assert tuple(got.shape) == (b, 1, h, vd)
    # the port follows the JAX reference's dtype (v's), which is what
    # the JAX package runs on the CPU
    assert str(got.dtype).removeprefix("torch.") == want_ref.dtype.name
    _close(got, want_ref, TOL[dtypes])
    _close(got, want_pallas, TOL[dtypes])
    # the empty slot (attend's fully-masked-row rule): exact zeros
    assert bool((got[0] == 0).all())


@pytest.mark.parametrize("dtypes", ["f32", "bf16"])
def test_flash_decode_scale_override(dtypes):
    b, cap, h, hd = 2, 32, 2, 16
    (jq, jk, jv), (q, k, v), jvalid, tvalid = _operands(
        ("scale", dtypes), b, cap, h, h, hd, hd, dtypes, [5, 32])
    got = ops.flash_decode(q, k, v, kv_valid_len=tvalid, scale=0.25)
    _close(got, jref.flash_decode_ref(jq, jk, jv, kv_valid_len=jvalid,
                                      scale=0.25), TOL[dtypes])
    _close(got, jops.flash_decode(jq, jk, jv, kv_valid_len=jvalid,
                                  scale=0.25, interpret=True), TOL[dtypes])


def test_flash_decode_ring_wraparound():
    """After the ring-buffer cursor wraps every cache slot is live:
    gqa_decode passes valid = min(pos + 1, cap) == cap."""
    b, cap, h, hkv, hd = 2, 16, 4, 2, 32
    pos = np.array([23, 16])
    (jq, jk, jv), (q, k, v), jvalid, tvalid = _operands(
        "ring", b, cap, h, hkv, hd, hd, "f32", np.minimum(pos + 1, cap))
    got = ops.flash_decode(q, k, v, kv_valid_len=tvalid)
    full = jref.flash_decode_ref(jq, jk, jv,
                                 kv_valid_len=jnp.full((b,), cap, jnp.int32))
    _close(got, full, TOL["f32"])
    _close(got, jops.flash_decode(jq, jk, jv, kv_valid_len=jvalid,
                                  interpret=True), TOL["f32"])


def test_plain_version_is_attend():
    """The registered plain version is exactly layers.attend with a
    ragged cache (bit-equal), as in the JAX package."""
    from repro_torch.models.layers import attend
    _, (q, k, v), _, valid = _operands("attend", 2, 7, 4, 4, 8, 8, "f32",
                                       [3, 7])
    fd = dispatch.get_kernel("flash_decode", "reference", "cpu")
    assert torch.equal(fd(q, k, v, kv_valid_len=valid),
                       attend(q, k, v, causal=False, kv_valid_len=valid))


def test_neg_inf_matches_jax():
    assert NEG_INF == JAX_NEG_INF


# ---------------------------------------------------------------------------
# registry resolution by device
# ---------------------------------------------------------------------------


def test_registry_and_contract_mirror_jax():
    assert dispatch.available_kernels()["flash_decode"] == ["pallas",
                                                            "reference"]
    mine = dispatch.kernel_contracts()["flash_decode"]
    theirs = jdispatch.kernel_contracts()["flash_decode"]
    assert (mine.family, mine.out) == (theirs.family, theirs.out) \
        == ("decode", "q^v")


@pytest.mark.parametrize("backend", ["auto", "pallas", "reference"])
def test_cpu_tensors_get_the_plain_version(backend):
    assert dispatch.get_kernel("flash_decode", backend, "cpu") \
        is ref.flash_decode_ref


def test_cuda_resolution_rule(monkeypatch):
    """On a CUDA device: `reference` is the plain version (no capability
    needed); auto/pallas is the Hopper kernel on compute capability
    (9, 0) and raises on any other card — never a silent fallback."""
    assert dispatch.get_kernel("flash_decode", "reference", "cuda") \
        is ref.flash_decode_ref
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda device=None: (9, 0))
    for backend in ("auto", "pallas"):
        assert dispatch.get_kernel("flash_decode", backend, "cuda") \
            is flash_decode_bhrd
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda device=None: (8, 0))
    with pytest.raises(RuntimeError, match="capability"):
        dispatch.get_kernel("flash_decode", "auto", "cuda")


def test_registry_rejects_bad_names():
    with pytest.raises(ValueError):
        dispatch.get_kernel("flash_decode", "triton", "cpu")
    with pytest.raises(KeyError):
        dispatch.get_kernel("no_such_kernel", "auto", "cpu")
    name = "flash_decode"
    with pytest.raises(ValueError):
        dispatch.register_kernel(name, "auto", ref.flash_decode_ref)
    with pytest.raises(ValueError):       # already registered
        dispatch.register_kernel(name, "reference", ref.flash_decode_ref)


def test_hopper_wrapper_refuses_cpu_tensors():
    """The kernel wrapper has no CPU path of its own (dispatch routes
    CPU tensors to the plain version); it neither launches nor counts."""
    _, (q, k, v), _, valid = _operands("cpu", 2, 8, 2, 2, 16, 16, "f32",
                                       [3, 8])
    before = flash_decode_bhrd.launches
    with pytest.raises(ValueError, match="CUDA"):
        flash_decode_bhrd(q, k, v, kv_valid_len=valid)
    assert flash_decode_bhrd.launches == before


@pytest.mark.parametrize("b,h,hkv,cap", [
    (8, 28, 4, 4096), (8, 28, 4, 1024), (4, 4, 1, 64), (2, 28, 2, 300),
    (1, 32, 32, 1),
])
def test_split_plan_covers_the_cache(b, h, hkv, cap):
    chunk, nsplit = split_plan(b, h, hkv, cap, n_sm=132)
    assert chunk % TILE == 0 and nsplit >= 1
    assert (nsplit - 1) * chunk < cap <= nsplit * chunk


# ---------------------------------------------------------------------------
# the Hopper kernel (needs the card)
# ---------------------------------------------------------------------------


def _row_scaled_err(got, want, valid):
    """max over (b, h) rows with valid > 0 of max|got - want| / max|want|
    in that row: the error in units of the row's own output size."""
    diff = (got.float() - want.float()).abs().amax(-1)     # (B, 1, H)
    size = want.float().abs().amax(-1)
    live = (valid > 0)[:, None, None].expand_as(size)
    return float((diff[live] / size[live]).max())


@pytest.mark.gpu
@pytest.mark.parametrize("dtypes", sorted(DTYPES))
def test_hopper_kernel_matches_plain_version(dtypes):
    """Tolerance: f32 2e-5 absolute. In bf16 the kernel and the plain
    version round the probabilities at different points and then round
    the output, so they differ by one to two bf16 ulps of the row's
    largest |output| (2**-7 each): the limit is four such ulps (2**-5)
    of each row's own size, whatever the row's valid length (outputs of
    long rows are averages of ~1e-2, the size of an absolute limit)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the Hopper kernel has no CPU mode)")
    b, cap, h, hkv, hd = 8, 1024, 28, 4, 128
    _, tx, _, valid = _operands(("gpu", dtypes), b, cap, h, hkv, hd, hd,
                                dtypes, [0, 1, cap - 1, cap, 5, 300, 777, 129])
    q, k, v = (t.cuda() for t in tx)
    valid = valid.cuda()
    before = flash_decode_bhrd.launches
    got = ops.flash_decode(q, k, v, kv_valid_len=valid)
    want = ref.flash_decode_ref(q, k, v, kv_valid_len=valid)
    torch.cuda.synchronize()
    assert flash_decode_bhrd.launches == before + 1
    assert got.dtype == want.dtype
    if dtypes == "f32":
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    else:
        assert _row_scaled_err(got, want, valid) <= 2.0 ** -5
    assert bool((got[0] == 0).all())
