"""The host side of the port's moe_expert_ffn kernel: ``plan``, the
padding, the live-tile count, and the wgmma design's arithmetic.

``plan`` picks the kernel's variant from dtype and shapes alone: ``wgmma``
for bf16 at every MoE config of ``configs/`` at full width (granite-moe-
1b-a400m, jamba-v0.1-52b, deepseek-v3-671b; none pads), ``wgmma`` with d
and ff zero-padded to multiples of 8 for ragged bf16 shapes, ``fma`` for
f32; ``mma_sync`` (the first bf16 design) only when forced. The tests
hold each plan's grids to the tile counts, its pass-2 tile width to the
waves rule, and its shared memory to what a Hopper block may use (227
KB). ``live_tiles`` counts the tiles that run their products for given
fills (the others are skipped, or store zeros).

``_wgmma_arithmetic`` spells the wgmma design's arithmetic in PyTorch on
the CPU: gate and up summed in f32, the SwiGLU in f32, the hidden rounded
to bf16 once, the down product summed in f32, one rounding of the output,
rows past the fill zero. It is held against JAX's Pallas kernel in
interpret mode and JAX's bf16 reference on the same numpy inputs, at the
limits of ``test_torch_moe_ffn.py`` (2e-2 and 5e-2), and the zero-padded
operands against the unpadded ones (zero columns add zero products).

The kernel itself runs only on a card (``test_torch_moe_ffn.py``'s
``gpu``-marked tests).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.models import moe as JM
from repro_torch.configs import get_config
from repro_torch.kernels.lora_matmul import SMS, WIDE_TILE_COST
from repro_torch.kernels.moe_ffn import (
    FMA_SMEM, MAX_SMEM, MMA_SYNC_SMEM, WGMMA_SMEM, live_tiles, pad_operands,
    plan)
from repro_torch.models import moe as PM

torch.set_num_threads(1)

BF16, F32 = torch.bfloat16, torch.float32
MOE_ARCHS = ["granite-moe-1b-a400m", "jamba-v0.1-52b", "deepseek-v3-671b"]


def _cdiv(a, b):
    return -(-a // b)


def _full_width(arch, tokens=4 * 1024):
    """(E, C, d, ff) of a config's MoE layer at the training path's
    4 x 1024 tokens."""
    cfg = get_config(arch)
    return (cfg.moe.n_experts, PM._capacity(cfg, tokens), cfg.d_model,
            cfg.moe.d_ff_expert)


def test_moe_configs_have_the_expected_shapes():
    assert _full_width("granite-moe-1b-a400m") == (32, 1280, 1024, 512)
    e, _, d, ff = _full_width("jamba-v0.1-52b")
    assert (e, d, ff) == (16, 4096, 14336)
    e, _, d, ff = _full_width("deepseek-v3-671b")
    assert (e, d, ff) == (256, 7168, 2048)


@pytest.mark.parametrize("tokens", [4 * 1024, 16 * 1024, 1000, 8])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_plan_picks_wgmma_for_bf16_at_every_moe_config(arch, tokens):
    e, c, d, ff = _full_width(arch, tokens)
    p = plan(e, c, d, ff, BF16)
    assert p.variant == "wgmma" and not p.padded
    assert (p.d_pad, p.ff_pad, p.block_m, p.width) == (d, ff, 128, 128)
    assert p.block_n in (128, 256)
    assert p.grid1 == (e * _cdiv(c, 128) * _cdiv(ff, 128), 1, 1)
    assert p.grid2 == (e * _cdiv(c, 128) * _cdiv(d, p.block_n), 1, 1)
    assert (p.smem1, p.smem2) == (WGMMA_SMEM[256], WGMMA_SMEM[p.block_n])
    assert max(p.smem1, p.smem2) <= MAX_SMEM


def test_plan_at_the_path_shape():
    """granite's training step: 1,280 tiles a pass (32 experts x 10 row
    tiles x 4 column tiles), pass 2 128 x 256 (10 waves of 132 SMs
    against 20 at 128 wide), 4 stages of 48 KB."""
    p = plan(32, 1280, 1024, 512, BF16)
    assert (p.variant, p.block_n, p.grid1, p.grid2, p.padded) == (
        "wgmma", 256, (1280, 1, 1), (1280, 1, 1), False)
    assert p.smem1 == p.smem2 == 4 * 48 * 1024 + 64 + 1024 == 197_696


@pytest.mark.parametrize("e,c,d,ff,d_pad,ff_pad,block_n", [
    (8, 1000, 1000, 500, 1000, 504, 256),     # ff not whole 16-byte rows
    (3, 77, 1001, 91, 1008, 96, 128),         # both ragged, one row tile
    (2, 37, 50, 70, 56, 72, 128),
    (1, 1, 1, 1, 8, 8, 128),
])
def test_plan_pads_ragged_bf16_to_multiples_of_8(e, c, d, ff, d_pad, ff_pad,
                                                 block_n):
    p = plan(e, c, d, ff, BF16)
    assert p.variant == "wgmma" and p.padded
    assert (p.d_pad, p.ff_pad, p.block_n) == (d_pad, ff_pad, block_n)
    assert p.grid1 == (e * _cdiv(c, 128) * _cdiv(ff_pad, 128), 1, 1)
    assert p.grid2 == (e * _cdiv(c, 128) * _cdiv(d_pad, block_n), 1, 1)


@pytest.mark.parametrize("shape", [(32, 1280, 1024, 512), (3, 77, 1001, 91),
                                   (16, 640, 4096, 14336)])
def test_plan_picks_fma_for_f32(shape):
    e, c, d, ff = shape
    p = plan(e, c, d, ff, F32)
    assert (p.variant, p.d_pad, p.ff_pad, p.padded) == ("fma", d, ff, False)
    assert p.grid1 == (_cdiv(ff, 32), _cdiv(c, 64), e)
    assert p.grid2 == (_cdiv(d, 64), _cdiv(c, 64), e)
    assert p.smem1 == p.smem2 == FMA_SMEM <= 48 * 1024


@pytest.mark.parametrize("shape", [(32, 1280, 1024, 512), (3, 77, 1001, 91)])
def test_forcing_mma_sync_gives_the_first_design(shape):
    e, c, d, ff = shape
    p = plan(e, c, d, ff, BF16, variant="mma_sync")
    assert (p.variant, p.d_pad, p.ff_pad, p.padded) == ("mma_sync", d, ff,
                                                        False)
    assert (p.block_m, p.width, p.block_n) == (128, 64, 128)
    assert p.grid1 == (_cdiv(ff, 64), _cdiv(c, 128), e)
    assert p.grid2 == (_cdiv(d, 128), _cdiv(c, 128), e)
    assert p.smem1 == MMA_SYNC_SMEM <= MAX_SMEM
    assert plan(e, c, d, ff, BF16, variant="wgmma") == plan(e, c, d, ff,
                                                           BF16)


def test_refusals():
    with pytest.raises(ValueError, match="takes torch.bfloat16"):
        plan(2, 8, 16, 16, F32, variant="wgmma")
    with pytest.raises(ValueError, match="takes torch.bfloat16"):
        plan(2, 8, 16, 16, F32, variant="mma_sync")
    with pytest.raises(ValueError, match="takes torch.float32"):
        plan(2, 8, 16, 16, BF16, variant="fma")
    with pytest.raises(ValueError, match="unknown"):
        plan(2, 8, 16, 16, BF16, variant="tma")
    with pytest.raises(ValueError, match="f32 or bf16"):
        plan(2, 8, 16, 16, torch.float16)
    with pytest.raises(ValueError, match="empty"):
        plan(0, 8, 16, 16, BF16)


@pytest.mark.parametrize("row_tiles", [1, 8, 64, 66, 132, 320, 1000, 2560])
@pytest.mark.parametrize("d_pad", [128, 1000, 1024, 4096, 7168])
def test_block_n_follows_the_waves_rule(row_tiles, d_pad):
    """256 wide unless its waves of blocks, each 1.6 times as long, cost
    more than 128's."""
    e, c = row_tiles, 128           # one row tile an expert
    p = plan(e, c, d_pad, 512, BF16)
    waves = {bn: _cdiv(row_tiles * _cdiv(d_pad, bn), SMS) for bn in (128, 256)}
    want = 256 if waves[256] * WIDE_TILE_COST < waves[128] else 128
    assert p.block_n == want


def test_shared_memory_of_each_ring():
    """192 KB of stages (48 KB: the 16 KB A tile and four 8 KB boxes; 32
    KB at block_n 128: two boxes), 16 bytes of barriers a stage, 1 KB of
    alignment slack; each fits a Hopper block."""
    for bn, stage in ((256, 16384 + 4 * 8192), (128, 16384 + 2 * 8192)):
        stages = 196608 // stage
        assert stages * stage == 196608
        assert WGMMA_SMEM[bn] == 196608 + 16 * stages + 1024 <= MAX_SMEM
    assert MMA_SYNC_SMEM == 3 * 2 * (128 * 72 + 64 * 136) == 107_520
    assert FMA_SMEM == 3 * 4 * (64 * 20 + 16 * 68) == 28_416


@pytest.mark.parametrize("fill,want", [
    (None, (1280, 1280)),
    ([1280] * 32, (1280, 1280)),
    ([0] * 32, (0, 0)),
    ([1] * 32, (32 * 4, 32 * 4)),                      # one row a tile
    ([128] * 32, (32 * 4, 32 * 4)),
    ([129] * 32, (32 * 2 * 4, 32 * 2 * 4)),
    ([1024] * 32, (32 * 8 * 4, 32 * 8 * 4)),           # the mean fill
    ([1280] * 16 + [0] * 16, (640, 640)),
    ([5000, -3] + [0] * 30, (10 * 4, 10 * 4)),         # clamped to [0, C]
])
def test_live_tiles_at_the_path_shape(fill, want):
    assert live_tiles(plan(32, 1280, 1024, 512, BF16), 1280, fill) == want


def test_live_tiles_of_other_plans():
    p = plan(8, 1000, 1000, 500, BF16)            # ff 504: 4 column tiles
    assert live_tiles(p, 1000, [1000] * 8) == (8 * 8 * 4, 8 * 8 * 4)
    assert live_tiles(p, 1000, [0, 1, 127, 128, 129, 500, 999, 1000]) == (
        (0 + 1 + 1 + 1 + 2 + 4 + 8 + 8) * 4,) * 2
    q = plan(8, 1000, 1000, 500, BF16, variant="mma_sync")
    assert live_tiles(q, 1000, [129] * 8) == (8 * 2 * 8, 8 * 2 * 8)
    f = plan(3, 77, 1001, 91, F32)                # 64-row tiles
    assert live_tiles(f, 77, [0, 64, 65]) == ((1 + 2) * 3, (1 + 2) * 16)
    assert live_tiles(f, 77, None) == (2 * 3 * 3, 16 * 2 * 3)


def _operands(shape, seed, dtype=BF16, fill=None, dirty=False):
    e, c, d, ff = shape
    rng = np.random.default_rng(np.random.SeedSequence((seed, *shape)))
    arrays = [rng.standard_normal((e, c, d), dtype=np.float32),
              rng.standard_normal((e, d, ff), dtype=np.float32) * d ** -0.5,
              rng.standard_normal((e, d, ff), dtype=np.float32) * d ** -0.5,
              rng.standard_normal((e, ff, d), dtype=np.float32) * ff ** -0.5]
    if fill is not None and not dirty:
        arrays[0][np.arange(c)[None, :] >= np.asarray(fill)[:, None]] = 0.0
    jx = [jnp.asarray(a).astype(jnp.bfloat16 if dtype == BF16 else
                                jnp.float32) for a in arrays]
    tx = [torch.from_numpy(a).to(dtype) for a in arrays]
    return jx, tx


def _wgmma_arithmetic(buf, wg, wu, wd, fill=None):
    """The wgmma design's arithmetic: f32 sums, the SwiGLU in f32, the
    hidden rounded to bf16, f32 sums, one rounding; rows past the fill
    zero."""
    gate = torch.einsum("ecd,edf->ecf", buf.float(), wg.float())
    up = torch.einsum("ecd,edf->ecf", buf.float(), wu.float())
    hidden = (torch.nn.functional.silu(gate) * up).to(buf.dtype)
    out = torch.einsum("ecf,efd->ecd", hidden.float(), wd.float())
    if fill is not None:
        live = torch.arange(buf.shape[1])[None, :] < fill[:, None]
        out = torch.where(live[..., None], out, 0.0)
    return out.to(buf.dtype)


@pytest.mark.parametrize("shape", [(4, 16, 32, 64), (3, 13, 24, 40),
                                   (2, 130, 72, 136)])
def test_wgmma_arithmetic_matches_jax(shape):
    jx, tx = _operands(shape, seed=1)
    got = _wgmma_arithmetic(*tx)
    want = jops.moe_expert_ffn(*jx, block_c=8, block_f=128, interpret=True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=2e-2,
                               atol=2e-2)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(JM.expert_ffn_reference(*jx),
                                          np.float32), rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("dirty", [False, True],
                         ids=["zero past the fill", "values past the fill"])
def test_wgmma_arithmetic_with_fill(dirty):
    """With each expert's fill, rows past it are exact zeros and the live
    rows are those of JAX's kernel on the buffer zeroed past the fill."""
    shape = (4, 24, 40, 72)
    fill = [0, 5, 24, 13]
    jx, tx = _operands(shape, seed=2, fill=fill, dirty=dirty)
    f = torch.tensor(fill, dtype=torch.int32)
    got = _wgmma_arithmetic(*tx, fill=f)
    past = torch.arange(shape[1])[None, :] >= f[:, None]
    assert bool((got[past] == 0).all()) and bool((got[~past] != 0).any())
    jbuf = jnp.where(jnp.asarray(~past.numpy())[..., None], jx[0], 0)
    want = np.asarray(jops.moe_expert_ffn(jbuf, *jx[1:], interpret=True),
                      np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2,
                               atol=2e-2)
    if not dirty:
        assert torch.equal(got, _wgmma_arithmetic(*tx))


@pytest.mark.parametrize("shape", [(3, 13, 21, 13), (2, 9, 1001, 91),
                                   (2, 9, 64, 500)])
def test_padding_changes_nothing(shape):
    """Zero columns of d and ff add zero products: the padded operands
    give the unpadded result, sliced back, at the f32 sums' precision;
    the padding itself is zeros."""
    e, c, d, ff = shape
    _, tx = _operands(shape, seed=3)
    p = plan(e, c, d, ff, BF16)
    assert p.padded and (p.d_pad % 8, p.ff_pad % 8) == (0, 0)
    pb, pg, pu, pd = pad_operands(p, *tx)
    assert pb.shape == (e, c, p.d_pad) and pd.shape == (e, p.ff_pad, p.d_pad)
    assert pg.shape == pu.shape == (e, p.d_pad, p.ff_pad)
    assert bool((pb[..., d:] == 0).all()) and bool((pg[:, d:] == 0).all())
    assert bool((pu[..., ff:] == 0).all()) and bool((pd[:, ff:] == 0).all())
    assert torch.equal(pb[..., :d], tx[0]) and torch.equal(pd[:, :ff, :d],
                                                           tx[3])
    got = _wgmma_arithmetic(pb, pg, pu, pd)[..., :d]
    want = _wgmma_arithmetic(*tx)
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               rtol=2.0 ** -7, atol=2.0 ** -7)
    # f32 operands: the same products, only the summation order moves
    f32 = [t.float() for t in tx]
    g32 = _wgmma_arithmetic(*pad_operands(p, *f32))[..., :d]
    np.testing.assert_allclose(g32.numpy(), _wgmma_arithmetic(*f32).numpy(),
                               rtol=1e-5, atol=1e-5)
    # an unpadded plan leaves the operands as they are
    q = plan(*shape[:2], 64, 128, BF16)
    _, ty = _operands((e, c, 64, 128), seed=4)
    assert all(a is b for a, b in zip(pad_operands(q, *ty), ty))
