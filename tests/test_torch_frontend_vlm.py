"""The PyTorch port's qwen2-vl-7b frontend order (M-RoPE and the vision
prefix) against the JAX package.

On reduced qwen2-vl-7b (``reduce_config``: 2 layers, d 128, GQA 4/2, hd
32, M-RoPE sections (4, 6, 6), qkv bias, an 8-patch vision stub), with
parameters crossed from the JAX package through numpy (the q/k/v biases
made nonzero, so the bias added after ``lora_matmul`` is exercised):

* ``text_positions`` and ``vlm_positions`` exactly equal (the default
  grid from sqrt(n_vis), so 256 patches give 16 x 16 and text starts at
  16; non-square counts; a given grid);
* ``mrope_cos_sin`` against JAX's at the full config's sections (16, 24,
  24) and the reduced ones, and, within the port, M-RoPE at uniform
  positions equal to ``rope_cos_sin`` bit for bit (the JAX package's
  ``tests/test_consistency.py`` property);
* ``_embed_inputs`` with and without the prefix (``vis_proj``, the
  position streams, ``n_prefix``);
* ``loss_fn`` and every LoRA gradient with the 8-patch ``vision_embeds``
  prefix: the plain path against JAX's ``reference`` backend in f32 and
  bf16 (the patches cast to the activations' dtype before the
  projection), and the kernel branches forced on the CPU
  (``dispatch.use_kernel`` true: ``lora_matmul`` and ``flash_attention``
  through their autograd Functions) against JAX's ``pallas`` backend in
  interpret mode; prefill's last-token logits;
* ``decode_step`` for several steps from a seeded cache with ragged
  cursors and per-slot adapters (M-RoPE tables at each slot's position
  in all three streams), logits every step and the whole cache after;
* a live JAX ``bench-tiny`` run of DevFT and FedIT through
  ``run_experiment`` on text-only batches, held by ``check_trajectory``
  (``tests/test_torch_runner.py``) at its unchanged limits.

Tolerances: f32 forward rtol = atol = 1e-5, gradients 1e-4 (summation
order only; the other port files' limits); bf16 the loss to 2**-8 of
its size and each gradient leaf to 5e-2 of its norm and of its largest
entry (``tests/test_torch_train.py``'s limits and argument). The
cos/sin tables agree with JAX's to 2**-21 absolute, a few f32 ulps, and
are not bit-equal: XLA's and PyTorch's f32 ``pow``, ``cos`` and ``sin``
round differently in the last bit (the port's ``rope_cos_sin`` tables
too, held at 1e-4 in ``tests/test_torch_model.py``); positions and
``n_prefix`` are integers and exactly equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduce_config as jax_reduce_config
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import interop
from repro_torch.configs import ReducedSpec, get_config, reduce_config
from repro_torch.kernels import dispatch
from repro_torch.models import layers as PL
from repro_torch.models import transformer as PT
from test_torch_runner import check_trajectory, run_both

torch.set_num_threads(1)

ARCH = "qwen2-vl-7b"
TOL = 1e-5
GRAD_TOL = 1e-4
TABLE_TOL = 2.0 ** -21


def _cfgs(test_spec, dtype="float32", backend="reference"):
    jcfg = jax_reduce_config(jax_get_config(ARCH), test_spec)
    pcfg = reduce_config(get_config(ARCH),
                         ReducedSpec(**dataclasses.asdict(test_spec)))
    return (dataclasses.replace(jcfg, dtype=dtype, kernel_backend=backend),
            dataclasses.replace(pcfg, dtype=dtype, kernel_backend=backend))


def _rng(*key):
    return np.random.default_rng(np.random.SeedSequence(
        [sum(map(ord, str(k))) for k in key]))


def _setup(jcfg, rng, batch=2, seq=16, prefix=True):
    """numpy params in the config's dtype (biases nonzero), an f32 LoRA
    with random ``b``, and a batch with one masked label and, with
    ``prefix``, ``n_frontend_tokens`` patch embeddings."""
    params = JT.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)

    def draw(path, a):
        a = np.asarray(a)
        if getattr(path[-1], "key", "") in ("bq", "bk", "bv"):
            a = a + 0.1 * rng.standard_normal(a.shape).astype(np.float32)
        return np.asarray(jnp.asarray(a).astype(jcfg.dtype))
    params = jax.tree_util.tree_map_with_path(draw, params)
    lora = jax.tree.map(
        lambda a: (0.05 * rng.standard_normal(a.shape)).astype(np.float32),
        JT.init_lora(jcfg, jax.random.PRNGKey(1), rank=4))
    out = {key: rng.integers(0, jcfg.vocab, (batch, seq)).astype(np.int32)
           for key in ("tokens", "labels")}
    out["labels"][1, 3] = -1
    if prefix:
        out["vision_embeds"] = rng.standard_normal(
            (batch, jcfg.n_frontend_tokens, jcfg.d_model)).astype(np.float32)
    return params, lora, out


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


# ---------------------------------------------------------------------------
# positions and rotary tables
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,n_vis,n_text,grid", [
    (2, 256, 16, None), (3, 8, 5, None), (1, 6, 4, None), (2, 12, 3, (3, 4)),
    (2, 0, 5, None)])
def test_positions_are_exactly_equal(b, n_vis, n_text, grid):
    got = PL.vlm_positions(b, n_vis, n_text, grid)
    want = np.asarray(JL.vlm_positions(b, n_vis, n_text, grid))
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    if n_vis == 256:                             # the 16 x 16 default grid
        assert int(got[1, 0, 255]) == int(got[2, 0, 255]) == 15
        assert got[:, 0, 256].tolist() == [16, 16, 16]
    for offset in (0, 7):
        np.testing.assert_array_equal(
            PL.text_positions(b, n_text, offset).numpy(),
            np.asarray(JL.text_positions(b, n_text, offset)))


@pytest.mark.parametrize("sections,hd", [((16, 24, 24), 128), ((4, 6, 6), 32)])
def test_mrope_tables_match_jax(sections, hd):
    pos = np.array(JL.vlm_positions(2, 256, 1024))
    jc, js = JL.mrope_cos_sin(jnp.asarray(pos), sections, hd, 1e6)
    pc, ps = PL.mrope_cos_sin(torch.from_numpy(pos), sections, hd, 1e6)
    assert tuple(pc.shape) == jc.shape == (2, 1280, hd // 2)
    assert pc.dtype == ps.dtype == torch.float32
    for g, w in ((pc, jc), (ps, js)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=TABLE_TOL)


def test_mrope_at_uniform_positions_is_rope_bit_for_bit():
    """Text tokens carry one position in all three streams: M-RoPE is
    then RoPE, bit for bit within the port (the JAX package holds the
    same property at 1e-5, ``tests/test_consistency.py``)."""
    rng = _rng("uniform")
    b, s, h, hd = 2, 300, 2, 128
    pos = PL.text_positions(b, s, 5)
    c1, s1 = PL.rope_cos_sin(pos, hd, 1e6)
    c2, s2 = PL.mrope_cos_sin(pos[None].expand(3, b, s), (16, 24, 24), hd,
                              1e6)
    assert torch.equal(c1, c2) and torch.equal(s1, s2)
    x = torch.from_numpy(rng.standard_normal((b, s, h, hd)).astype(np.float32))
    assert torch.equal(PL.apply_rope(x, c1, s1), PL.apply_rope(x, c2, s2))


@pytest.mark.parametrize("prefix", [True, False])
def test_embed_inputs_match_jax(prefix, test_spec):
    jcfg, pcfg = _cfgs(test_spec)
    params, _, batch = _setup(jcfg, _rng("embed", prefix), prefix=prefix)
    jx, jc, js, jn = JT._embed_inputs(jcfg, jax.tree.map(jnp.asarray, params),
                                      jax.tree.map(jnp.asarray, batch))
    px, pc, ps, pn = PT._embed_inputs(pcfg, interop.from_numpy_tree(params),
                                      batch)
    assert pn == jn == (jcfg.n_frontend_tokens if prefix else 0)
    assert tuple(px.shape) == jx.shape == (2, 16 + pn, jcfg.d_model)
    _close(px, jx)
    for g, w in ((pc, jc), (ps, js)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=TABLE_TOL)


# ---------------------------------------------------------------------------
# training and prefill with the vision prefix
# ---------------------------------------------------------------------------


def _jax_value_and_grad(jcfg, params, lora, batch):
    (total, metrics), grads = jax.jit(jax.value_and_grad(
        lambda lo, p, bt: JT.loss_fn(jcfg, p, lo, bt), has_aux=True))(
        *(jax.tree.map(jnp.asarray, t) for t in (lora, params, batch)))
    return total, metrics, grads


def _check(got, want, dtype):
    (pt, pm, pg), (jt, jm, jg) = got, want
    if dtype == "float32":
        for g, w in [(pt, jt)] + [(pm[k], jm[k]) for k in ("loss", "acc")]:
            np.testing.assert_allclose(float(g), float(w), rtol=TOL, atol=TOL)
    else:
        assert abs(float(pt) - float(jt)) <= 2.0 ** -8 * abs(float(jt))
    paths = interop.tree_paths(pg)
    assert [p for p, _ in paths] == [
        tuple(k.key for k in path)
        for path, _ in jax.tree_util.tree_flatten_with_path(jg)[0]]
    for (path, g), w in zip(paths, jax.tree.leaves(jg)):
        assert g.dtype == torch.float32, path
        g, w = g.numpy(), np.asarray(w, np.float32)
        assert np.abs(w).max() > 0, path
        if dtype == "float32":
            np.testing.assert_allclose(g, w, rtol=GRAD_TOL, atol=GRAD_TOL)
        else:
            assert np.linalg.norm(g - w) <= 5e-2 * np.linalg.norm(w), path
            assert np.abs(g - w).max() <= 5e-2 * np.abs(w).max(), path


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_lora_grads_with_a_vision_prefix_match_jax(dtype,
                                                            test_spec):
    jcfg, pcfg = _cfgs(test_spec, dtype)
    params, lora, batch = _setup(jcfg, _rng("grads", dtype))
    got = PT.loss_and_lora_grads(pcfg, interop.from_numpy_tree(params),
                                 interop.from_numpy_tree(lora), batch)
    _check(got, _jax_value_and_grad(jcfg, params, lora, batch), dtype)


def test_kernel_branch_with_a_vision_prefix_matches_jax_pallas(test_spec,
                                                               monkeypatch):
    """Every layer's W_q/W_v through ``lora_matmul`` (the bias added after
    it) and its causal attention over prefix + text through
    ``flash_attention``, forward and backward, against JAX's Pallas
    kernels in interpret mode."""
    jcfg, pcfg = _cfgs(test_spec, backend="pallas")
    params, lora, batch = _setup(jcfg, _rng("pallas"))
    calls = []
    for name in ("lora_matmul", "flash_attention"):
        real = getattr(PT.Lyr.ops, name)
        monkeypatch.setattr(PT.Lyr.ops, name,
                            lambda *a, _n=name, _f=real, **k:
                            calls.append((_n, k.get("causal"),
                                          tuple(a[0].shape))) or _f(*a, **k))
    monkeypatch.setattr(dispatch, "use_kernel", lambda backend, device: True)
    got = PT.loss_and_lora_grads(pcfg, interop.from_numpy_tree(params),
                                 interop.from_numpy_tree(lora), batch)
    n, s = pcfg.n_layers, 16 + pcfg.n_frontend_tokens
    assert [c for c in calls if c[0] == "flash_attention"] == [
        ("flash_attention", True, (2, s, pcfg.n_heads, pcfg.hd))] * n
    assert [c[2] for c in calls if c[0] == "lora_matmul"] == [
        (2, s, pcfg.d_model)] * 2 * n
    _check(got, _jax_value_and_grad(jcfg, params, lora, batch), "float32")


def test_prefill_with_a_vision_prefix_matches_jax(test_spec):
    jcfg, pcfg = _cfgs(test_spec)
    params, lora, batch = _setup(jcfg, _rng("prefill"))
    del batch["labels"]
    want = jax.jit(lambda p, lo, bt: JT.prefill(jcfg, p, lo, bt))(
        *(jax.tree.map(jnp.asarray, t) for t in (params, lora, batch)))
    got = PT.prefill(pcfg, interop.from_numpy_tree(params),
                     interop.from_numpy_tree(lora), batch)
    assert tuple(got.shape) == want.shape == (2, 1, pcfg.padded_vocab)
    _close(got, want)


# ---------------------------------------------------------------------------
# decoding
# ---------------------------------------------------------------------------


def test_decode_step_matches_jax(test_spec):
    """Several steps from a seeded cache whose slots sit at ragged
    cursors, with per-slot adapters laid out layer-major as the engine
    makes them: logits every step, then positions and the whole cache."""
    jcfg, pcfg = _cfgs(test_spec)
    rng = _rng("decode")
    b, cap, steps = 3, 12, 5
    params, _, _ = _setup(jcfg, rng)
    lora = jax.tree.map(
        lambda a: (0.05 * rng.standard_normal(
            (a.shape[0], b) + a.shape[1:])).astype(np.float32),
        JT.init_lora(jcfg, jax.random.PRNGKey(1), rank=4))
    cache = jax.tree.map(np.asarray, JT.init_cache(jcfg, b, cap, jnp.float32))
    cache["stacks"] = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32),
        cache["stacks"])
    cache["pos"] = np.array([0, 3, 6], np.int32)
    jc = jax.tree.map(jnp.asarray, cache)
    pc = interop.from_numpy_tree(cache)
    step = jax.jit(lambda p, lo, tok, c: JT.decode_step(jcfg, p, lo, tok, c))
    jp, jl = (jax.tree.map(jnp.asarray, t) for t in (params, lora))
    pp, pl = interop.from_numpy_tree(params), interop.from_numpy_tree(lora)
    for _ in range(steps):
        tok = rng.integers(0, jcfg.vocab, (b, 1)).astype(np.int32)
        jlog, jc = step(jp, jl, jnp.asarray(tok), jc)
        plog, pc = PT.decode_step(pcfg, pp, pl, torch.from_numpy(tok), pc)
        assert tuple(plog.shape) == jlog.shape
        _close(plog[..., :jcfg.vocab], np.asarray(jlog)[..., :jcfg.vocab])
    np.testing.assert_array_equal(pc["pos"].numpy(), np.asarray(jc["pos"]))
    for (path, got), want in zip(interop.tree_paths(pc["stacks"]),
                                 jax.tree.leaves(jc["stacks"])):
        _close(got, want)


# ---------------------------------------------------------------------------
# the training entry point on text-only batches
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method", ["devft", "fedit"])
def test_bench_tiny_on_qwen2_vl_matches_jax(method):
    got, want = run_both({"arch": ARCH, "method": method})
    check_trajectory(got, want)
    assert [log.capacity for log in got.logs] == (
        [2, 2, 2, 4, 4, 4] if method == "devft" else [4] * 6)
    assert got.metrics["comm_MB"] == want.metrics["comm_MB"]
