"""The host side of the port's ssd_scan kernel: ``plan``, the look-back's
ticket order and the high/low split, and the mma design's arithmetic.

``plan`` picks the kernel's variant from dtype, shape and alignment alone:
``mma`` for bf16 at every Mamba config (mamba2-2.7b: P 64, N 128;
jamba-v0.1: P 64, N 16; chunk 256), ``fma`` for f32, for P or N not a
multiple of 16, for chunks longer than the 256 rows an mma block keeps
in shared memory and for x, b or c off TMA's 16-byte alignment. The
tests hold every plan's shared memory to what a Hopper block may use,
its heads a block to the divisor of H / G that balances the card,
``chunk_order`` (the Python spelling of the ticket -> (batch, heads,
chunk) map the kernel uses) to a covering order in which each chunk's
predecessor holds an earlier ticket, and ``split_hi_lo`` (the split that
keeps the state's products in f32 precision) to its reconstruction
error. All exact or at stated limits.

``_emulate_mma`` spells the mma variant's arithmetic in PyTorch on the
CPU, chunk by chunk in the look-back's order: the weights (c.b) exp(cum_i
- cum_j) dt_j rounded to bf16 for the product with x, the inter term and
the state increment through high/low splits, f32 everywhere else, one
rounding of y. It is held against the JAX package's sequential oracle
(2**-7 of each (batch, head) slice's largest output, the limit
``chip_smoke.py`` holds the kernel to) and its chunked plain version
(2**-5), on the same numpy inputs.

The kernel itself runs only on a card (``test_torch_ssd_scan.py``'s
``gpu``-marked test).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.configs import get_config, reduce_config
from repro_torch.kernels.ssd_scan import (
    FMA_SMEM, MAX_SMEM, MMA_MAX_HPB, MMA_MAX_TILES, aligned, chunk_order,
    heads_per_block, mma_smem_bytes, plan, split_hi_lo)
from repro_torch.models import mamba2

torch.set_num_threads(1)

N_SM = 132                      # an H100 SXM
BF16, F32 = torch.bfloat16, torch.float32
MAMBA_ARCHS = ["mamba2-2.7b", "jamba-v0.1-52b"]


def _shape(cfg):
    """(H, P, G, N, chunk) of a config's Mamba layer."""
    mb = cfg.mamba
    return (mamba2.n_heads(cfg), mb.head_dim, mb.n_groups, mb.d_state,
            mb.chunk)


def test_mamba_configs_have_the_expected_shapes():
    assert _shape(get_config("mamba2-2.7b")) == (80, 64, 1, 128, 256)
    h, p, g, n, chunk = _shape(get_config("jamba-v0.1-52b"))
    assert (p, g, n, chunk) == (64, 1, 16, 256)


@pytest.mark.parametrize("s", [1024, 1000, 50])
@pytest.mark.parametrize("arch", MAMBA_ARCHS)
def test_plan_picks_mma_for_bf16_at_every_mamba_config(arch, s):
    h, p, g, n, chunk = _shape(get_config(arch))
    pl = plan(4, s, h, p, g, n, chunk, BF16, N_SM)
    assert pl.variant == "mma"
    assert pl.chunk == min(chunk, s)
    assert pl.nc == -(-s // pl.chunk)
    assert pl.tiles == -(-pl.chunk // 64) <= MMA_MAX_TILES
    assert (h // g) % pl.hpb == 0 and 1 <= pl.hpb <= MMA_MAX_HPB
    assert pl.grid == 4 * (h // pl.hpb) * pl.nc
    assert pl.workspace == 4 * 4 * h * (pl.nc - 1) * p * n
    assert pl.smem == mma_smem_bytes(n, pl.tiles) <= MAX_SMEM
    assert pl.waves == pytest.approx(pl.grid / N_SM)


def test_plan_at_the_path_shape():
    """mamba2-2.7b's training step: 1,280 (batch, head, chunk) items, ten
    heads a block, 128 blocks in one wave of one an SM, four resident
    tiles, and a 31.5 MB workspace."""
    pl = plan(4, 1024, 80, 64, 1, 128, 256, BF16, N_SM)
    assert (pl.variant, pl.grid, pl.hpb, pl.tiles, pl.nc) == (
        "mma", 128, 10, 4, 4)
    assert pl.workspace == 31_457_280
    assert pl.smem == 200_736


@pytest.mark.parametrize("bsz,h,g,nc,want", [
    (4, 80, 1, 4, 10),       # 1,280 items: 128 blocks of 10, one wave
    (2, 80, 1, 16, 10),      # S 4096: 256 blocks of 10, two waves
    (2, 64, 8, 4, 4),        # G 8: a block stays in its group of 8 heads
    (2, 128, 1, 4, 8),       # jamba: 128 blocks of 8
    (2, 4, 2, 4, 1),         # 16 items: one head a block, one wave
    (1, 7, 1, 1, 1),         # 7 items: one head a block, on 7 SMs
])
def test_heads_per_block_balances_the_card(bsz, h, g, nc, want):
    k = heads_per_block(bsz, h, g, nc, N_SM)
    assert k == want
    cost = lambda k: -(-bsz * (h // k) * nc // N_SM) * k  # noqa: E731
    assert all(cost(k) <= cost(j) for j in range(1, MMA_MAX_HPB + 1)
               if (h // g) % j == 0)


@pytest.mark.parametrize("arch", MAMBA_ARCHS)
def test_plan_of_reduced_configs(arch):
    h, p, g, n, chunk = _shape(reduce_config(get_config(arch)))
    assert plan(2, 64, h, p, g, n, chunk, BF16, N_SM).variant == "mma"
    assert plan(2, 64, h, p, g, n, chunk, F32, N_SM).variant == "fma"


@pytest.mark.parametrize("case", [
    ("f32", (4, 1024, 80, 64, 1, 128, 256, F32, True)),
    ("P48+8", (2, 64, 4, 56, 1, 128, 64, BF16, True)),
    ("N8", (2, 50, 4, 16, 2, 8, 16, BF16, True)),
    ("N120", (2, 64, 4, 64, 1, 120, 64, BF16, True)),
    ("chunk512", (2, 1024, 4, 64, 1, 128, 512, BF16, True)),
    ("misaligned", (4, 1024, 80, 64, 1, 128, 256, BF16, False)),
], ids=lambda c: c[0])
def test_plan_picks_fma_where_mma_does_not_take_the_call(case):
    _, args = case
    pl = plan(*args[:8], N_SM, args[8])
    assert pl.variant == "fma"
    assert (pl.grid, pl.tiles, pl.hpb, pl.smem, pl.workspace) == (
        args[0] * args[2], 0, 1, FMA_SMEM, 0)
    # forcing mma raises; forcing fma gives the same plan
    with pytest.raises(ValueError, match="mma does not take"):
        plan(*args[:8], N_SM, args[8], variant="mma")
    assert plan(*args[:8], N_SM, args[8], variant="fma") == pl


def test_forcing_fma_on_an_mma_shape_and_refusals():
    pl = plan(4, 1024, 80, 64, 1, 128, 256, BF16, N_SM, variant="fma")
    assert (pl.variant, pl.grid, pl.nc) == ("fma", 320, 4)
    with pytest.raises(ValueError, match="unknown"):
        plan(4, 1024, 80, 64, 1, 128, 256, BF16, N_SM, variant="wgmma")
    with pytest.raises(ValueError, match="P <= 64"):
        plan(1, 64, 2, 80, 1, 16, 64, BF16, N_SM)
    with pytest.raises(ValueError, match="N <= 128"):
        plan(1, 64, 2, 64, 1, 144, 64, F32, N_SM)
    with pytest.raises(ValueError, match="chunk <= 512"):
        plan(1, 1024, 2, 64, 1, 16, 1024, BF16, N_SM)
    with pytest.raises(ValueError, match="H % G"):
        plan(1, 64, 6, 64, 4, 16, 64, BF16, N_SM)
    with pytest.raises(ValueError, match="f32 or bf16"):
        plan(1, 64, 2, 64, 1, 16, 64, torch.float16, N_SM)


@pytest.mark.parametrize("n", [16, 32, 48, 64, 80, 96, 112, 128])
@pytest.mark.parametrize("chunk", [16, 64, 100, 256, 512])
def test_every_plan_fits_shared_memory(n, chunk):
    for dtype in (BF16, F32):
        pl = plan(2, 1024, 8, 64, 1, n, chunk, dtype, N_SM)
        assert 0 < pl.smem <= MAX_SMEM
        assert pl.variant == ("mma" if dtype == BF16 and chunk <= 256
                              else "fma")


def test_aligned_reads_base_addresses_and_strides():
    xbc = torch.zeros(2, 16, 5120 + 256, dtype=BF16)
    x = xbc[..., :5120].reshape(2, 16, 80, 64)
    b = xbc[..., 5120:5248].reshape(2, 16, 1, 128)
    c = xbc[..., 5248:].reshape(2, 16, 1, 128)
    assert xbc.data_ptr() % 16 == 0
    assert aligned(x, b, c)
    # two elements off: the base moves by 4 bytes
    off = torch.zeros(2, 16, 2 + 5120 + 256, dtype=BF16)
    assert not aligned(off[..., 2:5122].reshape(2, 16, 80, 64))
    # a row stride of 5,378 elements is no whole 16-byte step
    assert not aligned(off[..., :5120].reshape(2, 16, 80, 64))
    # f32 rows of 4 elements are 16 bytes; of 2 elements they are not
    assert aligned(torch.zeros(3, 4, dtype=F32))
    assert not aligned(torch.zeros(3, 2, dtype=F32))


@pytest.mark.parametrize("bsz,h,nc,hpb", [(4, 80, 4, 10), (2, 80, 16, 10),
                                          (3, 5, 1, 5), (1, 1, 7, 1),
                                          (2, 64, 4, 4)])
def test_chunk_order_covers_each_chunk_once_after_its_predecessor(bsz, h,
                                                                  nc, hpb):
    order = chunk_order(bsz, h, nc, hpb)
    assert len(order) == bsz * h // hpb * nc
    ticket = {(b, h0 + j, ci): t for t, (b, h0, ci) in enumerate(order)
              for j in range(hpb)}
    assert sorted(ticket) == [(b, hh, ci) for b in range(bsz)
                              for hh in range(h) for ci in range(nc)]
    for (b, hh, ci), t in ticket.items():
        if ci > 0:
            assert ticket[(b, hh, ci - 1)] < t


def test_split_hi_lo_reconstructs_f32_states():
    rng = np.random.default_rng(0)
    t = torch.from_numpy((rng.standard_normal(4096) * np.exp(
        rng.uniform(-30, 30, 4096))).astype(np.float32))
    t[:4] = torch.tensor([0.0, 1.0, -3.0e-38, 1.0 + 2.0 ** -20])
    hi, lo = split_hi_lo(t)
    assert hi.dtype == lo.dtype == BF16
    rel = ((hi.float() + lo.float()) - t).abs() / t.abs().clamp_min(1e-30)
    assert float(rel.max()) <= 2.0 ** -16
    # the high part alone, as plain bf16, is off by up to 2**-9
    assert float(((hi.float() - t).abs() / t.abs().clamp_min(1e-30)).max()) \
        > 2.0 ** -12


def _emulate_mma(x, dt, a, b, c, d, chunk):
    """The mma variant's arithmetic, chunk by chunk, on f32 CPU tensors
    (x, b, c hold bf16 values): returns y in bf16."""
    bsz, s, h, p = x.shape
    rep = h // b.shape[2]
    chunk = min(chunk, s)
    y = torch.zeros((bsz, s, h, p))
    state = torch.zeros((bsz, h, p, b.shape[3]))
    for s0 in range(0, s, chunk):
        cl = min(chunk, s - s0)
        xs, dts = x[:, s0:s0 + cl], dt[:, s0:s0 + cl]
        bs = torch.repeat_interleave(b[:, s0:s0 + cl], rep, dim=2)
        cs = torch.repeat_interleave(c[:, s0:s0 + cl], rep, dim=2)
        cum = torch.cumsum(dts * a, dim=1)                  # (B, cl, H)
        last = cum[:, -1]                                   # (B, H)
        diff = cum[:, :, None, :] - cum[:, None, :, :]      # (B, i, j, H)
        mask = torch.tril(torch.ones(cl, cl, dtype=torch.bool))
        decay = torch.exp(torch.where(mask[None, :, :, None], diff,
                                      torch.tensor(-torch.inf)))
        w = (torch.einsum("bihn,bjhn->bijh", cs, bs) * decay
             * dts[:, None]).to(BF16).float()
        intra = torch.einsum("bijh,bjhp->bihp", w, xs)
        hi, lo = split_hi_lo(state)
        inter = torch.exp(cum)[..., None] * (
            torch.einsum("bihn,bhpn->bihp", cs, hi.float())
            + torch.einsum("bihn,bhpn->bihp", cs, lo.float()))
        xh, xl = split_hi_lo(
            xs * (dts * torch.exp(last[:, None] - cum))[..., None])
        state = state * torch.exp(last)[..., None, None] + (
            torch.einsum("bjhp,bjhn->bhpn", xh.float(), bs)
            + torch.einsum("bjhp,bjhn->bhpn", xl.float(), bs))
        y[:, s0:s0 + cl] = intra + inter + d[:, None] * xs
    return y.to(BF16)


EMU = [  # S, H, P, N, G, chunk, a, dt shift
    (64, 4, 16, 16, 2, 16, None, 0.0),
    (128, 2, 64, 128, 1, 64, None, 0.0),
    (100, 4, 32, 16, 4, 32, None, 0.0),        # ragged: a short last chunk
    (50, 2, 16, 16, 1, 64, None, 0.0),         # one chunk shorter than a tile
    (128, 2, 64, 32, 1, 64, -16.0, 3.0),       # cum ~ -3000: exp(cum) is 0
]


@pytest.mark.parametrize("case", EMU, ids=[f"S{c[0]}H{c[1]}P{c[2]}N{c[3]}"
                                           f"G{c[4]}c{c[5]}"
                                           + ("-underflow" if c[6] else "")
                                           for c in EMU])
def test_mma_arithmetic_matches_the_jax_oracle(case):
    s, h, p, n, g, chunk, a_scale, shift = case
    assert plan(2, s, h, p, g, n, chunk, BF16, N_SM).variant == "mma"
    rng = np.random.default_rng(np.random.SeedSequence((11, *case[:6])))
    bf = lambda v: np.array(jnp.asarray(v).astype(jnp.bfloat16)  # noqa
                              .astype(jnp.float32))
    x = bf(rng.standard_normal((2, s, h, p), dtype=np.float32))
    b = bf(rng.standard_normal((2, s, g, n), dtype=np.float32) * 0.5)
    c = bf(rng.standard_normal((2, s, g, n), dtype=np.float32) * 0.5)
    dt = np.log1p(np.exp(rng.standard_normal((2, s, h)).astype(np.float32)
                         + shift)).astype(np.float32)
    a = (-np.linspace(1.0, 16.0, h) if a_scale is None
         else np.full(h, a_scale)).astype(np.float32)
    d = rng.standard_normal(h).astype(np.float32)
    got = _emulate_mma(*(torch.from_numpy(v) for v in (x, dt, a, b, c, d)),
                       chunk).float().numpy()
    assert np.isfinite(got).all()
    oracle = np.asarray(jref.ssd_scan_bshp_ref(
        *(jnp.asarray(v) for v in (x, dt, a, b, c, d))))
    low = [jnp.asarray(v).astype(jnp.bfloat16) for v in (x, b, c)]
    plain = np.asarray(jref.ssd_scan_bshp_chunked_ref(
        low[0], jnp.asarray(dt), jnp.asarray(a), low[1], low[2],
        jnp.asarray(d), chunk=chunk).astype(jnp.float32))
    for want, tol in ((oracle, 2.0 ** -7), (plain, 2.0 ** -5)):
        diff = np.abs(got - want).max(axis=(1, 3))
        size = np.abs(want).max(axis=(1, 3))
        assert float((diff / size).max()) <= tol
