"""The host side of the port's flash_decode kernel: ``plan`` and the live
work list.

``plan`` picks the kernel's variant from shapes and dtypes alone (it
never reads ``kv_valid_len``, which lives on the card): ``tma_mma`` for
bf16 q and cache at every decoding config, ``fma`` for the f32 cases and
for any shape ``tma_mma`` does not take (MLA's hd 576 / vd 512). The
tests hold the plan's shared memory to the 227 KB a Hopper block may
use, and ``live_chunks`` (the Python spelling of the list the kernel
builds on the card from ``kv_valid_len``) to a brute-force count of the
live (slot, chunk) pairs. All CPU-only and exact (integers).

The kernel itself runs only on a card: the ``gpu``-marked test at the
end skips without one.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import ALL_ARCH_IDS, get_config
from repro_torch.kernels import ref
from repro_torch.kernels.flash_decode import (
    MAX_SMEM, MMA_MAX_CHUNKS, MMA_MAX_STAGES, MMA_MIN_STAGES, MMA_TILE,
    flash_decode_bhrd, live_chunks, mma_chunk, plan, reset_counts)
from repro_torch.models.transformer import PORTED_KINDS, stack_kinds

torch.set_num_threads(1)

N_SM = 132                      # an H100 SXM
BF16, F32 = torch.bfloat16, torch.float32
DTYPES = {"bf16": (BF16, BF16), "f32q-bf16kv": (F32, BF16), "f32": (F32, F32)}
#: the configs with attention whose every layer kind decodes in the port
DECODING = [a for a in ALL_ARCH_IDS
            if set(stack_kinds(get_config(a)).values()) <= set(PORTED_KINDS)
            and get_config(a).n_heads]


def test_decoding_configs_are_the_expected_ones():
    assert {"qwen2-7b", "qwen3-32b", "phi4-mini-3.8b", "minicpm-2b",
            "llama2-7b-proxy", "granite-moe-1b-a400m", "jamba-v0.1-52b",
            "deepseek-v3-671b"} <= set(DECODING)
    assert "mamba2-2.7b" not in DECODING      # decodes, with no attention


def _decode_shape(cfg):
    """(H, Hkv, hd, vd) of a config's decode attention: MLA attends over
    its latent (one kv head, hd = kv rank + rope, vd = kv rank)."""
    if cfg.attn_kind == "mla":
        m = cfg.mla
        return (cfg.n_heads, 1, m.kv_lora_rank + m.qk_rope_head_dim,
                m.kv_lora_rank)
    return cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.hd


@pytest.mark.parametrize("b,cap", [(8, 1024), (8, 4096), (1, 4096),
                                   (64, 2048)])
@pytest.mark.parametrize("dtypes", sorted(DTYPES))
@pytest.mark.parametrize("arch", DECODING)
def test_plan_fits_every_decoding_config(arch, dtypes, b, cap):
    h, hkv, hd, vd = _decode_shape(get_config(arch))
    q_dtype, kv_dtype = DTYPES[dtypes]
    p = plan(b, h, hkv, cap, hd, vd, q_dtype, kv_dtype, N_SM)
    assert p.variant == ("tma_mma" if dtypes == "bf16" and max(hd, vd)
                         <= 128 else "fma")
    assert 0 < p.smem <= MAX_SMEM
    assert p.chunk % (MMA_TILE if p.variant == "tma_mma" else 128) == 0
    assert (p.nchunk - 1) * p.chunk < cap <= p.nchunk * p.chunk
    if p.variant == "tma_mma":
        assert MMA_MIN_STAGES <= p.stages <= MMA_MAX_STAGES
        assert p.grid == (min(N_SM, b * hkv * p.nchunk), 1, 1)
    else:
        assert p.grid == (p.nchunk, hkv * -(-(h // hkv) // 8), b)


@pytest.mark.parametrize("dtypes", sorted(DTYPES))
def test_mla_shape_gets_the_fma_variant(dtypes):
    """Absorbed-MLA decode (deepseek-v3): hd 576 = 512 + 64, vd 512, one
    kv head, 128 query heads. Wider than tma_mma's 128 and 16, so the
    plan gives fma, and a forced tma_mma says why it does not fit."""
    q_dtype, kv_dtype = DTYPES[dtypes]
    p = plan(4, 128, 1, 512, 576, 512, q_dtype, kv_dtype, N_SM)
    assert p.variant == "fma" and p.smem <= MAX_SMEM
    with pytest.raises(ValueError, match="tma_mma does not take"):
        plan(4, 128, 1, 512, 576, 512, q_dtype, kv_dtype, N_SM,
             variant="tma_mma")


@pytest.mark.parametrize("case,match", [
    (dict(q_dtype=F32, kv_dtype=BF16), "bf16 q and cache"),
    (dict(q_dtype=F32, kv_dtype=F32), "bf16 q and cache"),
    (dict(hd=256, vd=256), "multiples of 16 up to 128"),
    (dict(hd=120, vd=120), "multiples of 16 up to 128"),
    (dict(h=34, hkv=2), "up to 16 query heads"),
    (dict(b=5000), "up to 4096 slots"),
])
def test_forced_tma_mma_raises_where_it_does_not_fit(case, match):
    args = dict(b=8, h=28, hkv=4, cap=1024, hd=128, vd=128, q_dtype=BF16,
                kv_dtype=BF16)
    args.update(case)
    with pytest.raises(ValueError, match=match):
        plan(args["b"], args["h"], args["hkv"], args["cap"], args["hd"],
             args["vd"], args["q_dtype"], args["kv_dtype"], N_SM,
             variant="tma_mma")


def test_forced_variants_that_do_not_fit_raise():
    with pytest.raises(ValueError, match="unknown flash_decode variant"):
        plan(8, 28, 4, 1024, 128, 128, BF16, BF16, N_SM, variant="wgmma")
    with pytest.raises(ValueError, match="wider than one block's columns"):
        plan(2, 2, 1, 64, 16, 1024, F32, F32, N_SM, variant="fma")
    with pytest.raises(ValueError, match="more shared memory"):
        plan(2, 2, 1, 64, 16384, 64, BF16, BF16, N_SM, variant="fma")
    with pytest.raises(ValueError, match="H % Hkv"):
        plan(2, 6, 4, 64, 64, 64, BF16, BF16, N_SM)
    # the first design takes the path shape on bf16 too (the measurement's
    # yardstick), and the plan never picks it there by itself
    p = plan(8, 28, 4, 4096, 128, 128, BF16, BF16, N_SM, variant="fma")
    assert p.variant == "fma"
    assert plan(8, 28, 4, 4096, 128, 128, BF16, BF16, N_SM).variant \
        == "tma_mma"


@pytest.mark.parametrize("b,hkv,cap,want", [
    (8, 4, 4096, 1024),     # qwen2-7b path: a quarter of the cache
    (8, 4, 1024, 256),      # the serving phase's capacity
    (1, 4, 4096, 128),      # one slot: short enough for an item per SM
    (1, 32, 4096, 1024),    # llama2-7b-proxy, one slot
    (4, 1, 64, 64),         # shorter than a tile
    (64, 8, 2048, 512),
    (3, 2, 300, 64),        # few slots: the shortest chunk
])
def test_mma_chunk_rule(b, hkv, cap, want):
    chunk = mma_chunk(b, hkv, cap, N_SM)
    assert chunk == want
    assert chunk % MMA_TILE == 0 and MMA_TILE <= chunk
    full = -(-cap // chunk)
    # a full slot is cut into at most MMA_MAX_CHUNKS chunks, or into more
    # when fewer would leave SMs without an item
    longer = b * hkv * -(-cap // (chunk + MMA_TILE))
    assert full <= MMA_MAX_CHUNKS or longer < N_SM


def _live_pairs_brute(valid, cap, chunk):
    """Every (slot, chunk) with a row below the slot's clamped length."""
    pairs = set()
    for b, n in enumerate(valid):
        live = min(max(int(n), 0), cap)
        for c in range(-(-cap // chunk)):
            if c * chunk < live:
                pairs.add((b, c))
    return pairs


def _item_at(it, prefix, vlen, hkv, chunk):
    """The kernel's ``item_at``: binary search of the exclusive prefix of
    live chunks per slot for the slot of list entry it // Hkv."""
    j = it // hkv
    lo, hi = 0, len(vlen) - 1
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if prefix[mid] <= j:
            lo = mid
        else:
            hi = mid - 1
    c = j - prefix[lo]
    return lo, it % hkv, c, c * chunk, min(c * chunk + chunk, vlen[lo])


@pytest.mark.parametrize("seed", range(6))
def test_live_chunks_cover_each_live_chunk_once(seed):
    rng = np.random.default_rng(seed)
    cap = int(rng.choice([64, 300, 1024, 4096]))
    chunk = int(rng.choice([64, 128, 256]))
    b = int(rng.integers(1, 40))
    fixed = [0, 1, cap - 1, cap, cap + 7, -3]
    valid = (fixed + list(rng.integers(0, cap + 1, size=b)))[:max(b, 6)]
    pairs = live_chunks(valid, cap, chunk)
    assert len(pairs) == len(set(pairs))
    assert set(pairs) == _live_pairs_brute(valid, cap, chunk)
    assert pairs == sorted(pairs)                 # slot-major, chunk order
    # the kernel's arithmetic on the card gives the same list, and the
    # stride walk of any grid takes every item exactly once
    vlen = [min(max(int(n), 0), cap) for n in valid]
    counts = [-(-n // chunk) for n in vlen]
    prefix = list(np.concatenate([[0], np.cumsum(counts)]))
    hkv = int(rng.integers(1, 5))
    items = prefix[-1] * hkv
    assert items == len(pairs) * hkv
    grid = int(rng.integers(1, 140))
    taken = []
    for x in range(grid):
        for it in range(x, items, grid):
            b_, kvh, c, c0, c1 = _item_at(it, prefix, vlen, hkv, chunk)
            assert (b_, c) == pairs[it // hkv] and kvh == it % hkv
            assert c0 < c1 <= vlen[b_] and c1 - c0 <= chunk
            taken.append(it)
    assert sorted(taken) == list(range(items))


def test_reset_counts():
    flash_decode_bhrd.launches = 5
    flash_decode_bhrd.variants["tma_mma"] += 3
    reset_counts()
    assert flash_decode_bhrd.launches == 0
    assert dict(flash_decode_bhrd.variants) == {}


# ---------------------------------------------------------------------------
# the tma_mma kernel (needs the card)
# ---------------------------------------------------------------------------


@pytest.mark.gpu
def test_hopper_tma_mma_ignores_rows_past_valid():
    """NaN in the cache at or past each slot's valid length changes no bit
    of the output; the call runs the tma_mma variant, and its shared
    memory is the plan's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the Hopper kernel has no CPU mode)")
    from repro_torch.kernels.flash_decode import library_smem_bytes, sm_count
    b, cap, h, hkv, hd = 8, 1024, 28, 4, 128
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
               .cuda().bfloat16()
               for s in ((b, 1, h, hd), (b, cap, hkv, hd), (b, cap, hkv, hd)))
    valid = torch.tensor([0, 1, cap - 1, cap, 5, 300, 777, 129],
                         dtype=torch.int32, device="cuda")
    dead = (torch.arange(cap, device="cuda")[None, :]
            >= valid[:, None])[:, :, None, None]
    k0, v0 = k.masked_fill(dead, 0.0), v.masked_fill(dead, 0.0)
    reset_counts()
    got = flash_decode_bhrd(q, k.masked_fill(dead, float("nan")),
                            v.masked_fill(dead, float("nan")),
                            kv_valid_len=valid)
    zero = flash_decode_bhrd(q, k0, v0, kv_valid_len=valid)
    torch.cuda.synchronize()
    assert dict(flash_decode_bhrd.variants) == {"tma_mma": 2}
    assert torch.equal(got, zero)
    want = ref.flash_decode_ref(q, k0, v0, kv_valid_len=valid)
    diff = (zero.float() - want.float()).abs().amax(-1)[1:]
    assert bool((diff <= 2.0 ** -5 * want.float().abs().amax(-1)[1:]).all())
    assert bool((zero[0] == 0).all())
    p = plan(b, h, hkv, cap, hd, hd, torch.bfloat16, torch.bfloat16,
             sm_count(q.device))
    assert library_smem_bytes(p, b, h, hkv, hd, hd, torch.bfloat16) == p.smem
