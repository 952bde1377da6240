"""The PyTorch port's dense model path against the JAX package.

Parameters are made once by the JAX package, moved to numpy and handed
to both (``repro_torch.interop``): ``jax.random`` cannot be reproduced by
torch. LoRA ``b`` factors are random (``init_lora`` zeroes them, which
would leave the adapter path untested). Everything else — activations,
tokens, cache contents, ragged cursors — is numpy from a seed.

Tolerances: f32 rtol = atol = 1e-4 (summation order differs between
XLA and PyTorch); the bf16-cache case (f32 params against a bf16 KV
cache, as the serve CLI runs) 1e-2, since one bf16 rounding of the
attention output may land on the other side.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduce_config as jax_reduce_config
from repro.lora import lora as jlora
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import interop
from repro_torch.configs import ReducedSpec, get_config, reduce_config
from repro_torch.lora import lora as plora
from repro_torch.models import layers as PL
from repro_torch.models import transformer as PT

torch.set_num_threads(1)

F32_TOL = 1e-4
BF16_TOL = 1e-2
ARCHS = ["qwen2-7b", "llama2-7b-proxy", "qwen2-vl-7b", "whisper-tiny"]


def _cfgs(arch, test_spec, dtype="float32"):
    """The same reduced config in both packages (dtype = cache dtype)."""
    jcfg = dataclasses.replace(jax_reduce_config(jax_get_config(arch),
                                                 test_spec), dtype=dtype)
    pcfg = dataclasses.replace(
        reduce_config(get_config(arch),
                      ReducedSpec(**dataclasses.asdict(test_spec))),
        dtype=dtype)
    return jcfg, pcfg


def _rng(*key):
    parts = [k if isinstance(k, int) else int.from_bytes(k.encode(), "big")
             for k in key]
    return np.random.default_rng(np.random.SeedSequence(parts))


def _np_params(jcfg, rng):
    """JAX-initialised params with random biases and norm scales (so the
    bias and norm paths are exercised), as numpy."""
    params = jax.tree.map(np.asarray,
                          JT.init_params(jcfg, jax.random.PRNGKey(0),
                                         jnp.float32))

    def perturb(path, a):
        name = getattr(path[-1], "key", "")
        if name in ("bq", "bk", "bv", "ln1", "ln2", "final_norm"):
            return a + 0.1 * rng.standard_normal(a.shape).astype(a.dtype)
        return a
    return jax.tree_util.tree_map_with_path(perturb, params)


def _np_lora(jcfg, rng, rank=4, batch=None):
    """A LoRA tree with nonzero ``b``; ``batch`` adds a per-slot axis
    after the layer axis, ``(L, B, din, r)``, as the engine gathers."""
    tmpl = JT.init_lora(jcfg, jax.random.PRNGKey(1), rank=rank)

    def draw(a):
        shape = a.shape if batch is None else (a.shape[0], batch) + a.shape[1:]
        return (0.05 * rng.standard_normal(shape)).astype(np.float32)
    return jax.tree.map(draw, tmpl)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.float()),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# layer functions
# ---------------------------------------------------------------------------


def test_rms_norm_and_rope():
    rng = _rng("norm-rope")
    x = rng.standard_normal((2, 3, 4, 32)).astype(np.float32)
    scale = rng.standard_normal(32).astype(np.float32)
    _close(PL.rms_norm(torch.from_numpy(x), torch.from_numpy(scale), 1e-6),
           JL.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-6), F32_TOL)
    pos = rng.integers(0, 1000, size=(2, 3)).astype(np.int32)
    jc, js = JL.rope_cos_sin(jnp.asarray(pos), 32, 1e6)
    pc, ps = PL.rope_cos_sin(torch.from_numpy(pos), 32, 1e6)
    _close(pc, jc, F32_TOL)
    _close(ps, js, F32_TOL)
    _close(PL.apply_rope(torch.from_numpy(x), pc, ps),
           JL.apply_rope(jnp.asarray(x), jc, js), F32_TOL)


@pytest.mark.parametrize("kw", [
    dict(causal=True),
    dict(causal=True, window=3),
    dict(causal=True, q_offset=4),
    dict(causal=False, kv_valid=[0, 2]),
    dict(causal=True, window=2, kv_valid=[5, 1]),
], ids=["causal", "window", "offset", "ragged", "window-ragged"])
def test_attend_matches_jax(kw):
    """The plain attention core in all its masking modes, GQA rep 2,
    including fully masked rows (which must give zeros)."""
    rng = _rng("attend", str(kw))
    q = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 9, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 9, 2, 8)).astype(np.float32)
    kw = dict(kw)
    valid = kw.pop("kv_valid", None)
    jv = None if valid is None else jnp.asarray(valid, jnp.int32)
    tv = None if valid is None else torch.tensor(valid, dtype=torch.int32)
    got = PL.attend(torch.from_numpy(q), torch.from_numpy(k),
                    torch.from_numpy(v), kv_valid_len=tv, **kw)
    want = JL.attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     kv_valid_len=jv, **kw)
    _close(got, want, F32_TOL)


@pytest.mark.parametrize("batched", [False, True], ids=["2d", "per-slot"])
@pytest.mark.parametrize("alpha", [None, 3.0])
def test_proj_with_lora(batched, alpha):
    """x @ w + s * (x @ a) @ b + bias, with 2-D or per-slot (B, din, r)
    factors and alpha defaulting to 2r."""
    rng = _rng("proj", int(batched), str(alpha))
    x = rng.standard_normal((3, 1, 16)).astype(np.float32)
    w = rng.standard_normal((16, 12)).astype(np.float32)
    bias = rng.standard_normal(12).astype(np.float32)
    lead = (3,) if batched else ()
    lora = {"a": rng.standard_normal(lead + (16, 4)).astype(np.float32),
            "b": rng.standard_normal(lead + (4, 12)).astype(np.float32)}
    if alpha is not None:
        lora["alpha"] = alpha
    assert PL.lora_scaling(lora) == JL.lora_scaling(lora)
    want = JL._proj(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias),
                    jax.tree.map(jnp.asarray, lora))
    got = PL._proj(torch.from_numpy(x), torch.from_numpy(w),
                   torch.from_numpy(bias), interop.from_numpy_tree(lora))
    _close(got, want, F32_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_gqa_qkv_and_mlp(arch, test_spec):
    jcfg, pcfg = _cfgs(arch, test_spec)
    rng = _rng("qkv", arch)
    # the decoder stack of the enc-dec order, the only stack elsewhere
    stack = "dec" if jcfg.is_encdec else "layers"
    layer = jax.tree.map(lambda a: a[0],
                         _np_params(jcfg, rng)["blocks"][stack])
    lora = jax.tree.map(lambda a: a[0], _np_lora(jcfg, rng)[stack])
    x = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
    pos = np.array([[3], [11]], np.int32)
    jc, js = JL.rope_cos_sin(jnp.asarray(pos), jcfg.hd, jcfg.rope_theta)
    pc, ps = PL.rope_cos_sin(torch.from_numpy(pos), pcfg.hd, pcfg.rope_theta)
    want = JL.gqa_qkv(jax.tree.map(jnp.asarray, layer["mixer"]), jcfg,
                      jnp.asarray(x), jc, js,
                      lora=jax.tree.map(jnp.asarray, lora))
    got = PL.gqa_qkv(interop.from_numpy_tree(layer["mixer"]), pcfg,
                     torch.from_numpy(x), pc, ps,
                     lora=interop.from_numpy_tree(lora))
    for g, w in zip(got, want):
        _close(g, w, F32_TOL)
    _close(PL.mlp(interop.from_numpy_tree(layer["ffn"]), torch.from_numpy(x)),
           JL.mlp(jax.tree.map(jnp.asarray, layer["ffn"]), jnp.asarray(x)),
           F32_TOL)


# ---------------------------------------------------------------------------
# whole-model structure and decode_step
# ---------------------------------------------------------------------------


def _structure(tree):
    return [(tuple(p), tuple(a.shape), str(a.dtype).removeprefix("torch."))
            for p, a in tree]


def _jax_structure(tree):
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return [(tuple(getattr(k, "key", k) for k in path), tuple(a.shape),
             a.dtype.name) for path, a in leaves]


@pytest.mark.parametrize("arch", ARCHS)
def test_init_trees_mirror_jax(arch, test_spec):
    """Same key paths, leaf order, shapes and dtypes as the JAX package's
    params, LoRA and decode cache (the stacked (L, ...) layout)."""
    jcfg, pcfg = _cfgs(arch, test_spec, dtype="bfloat16")
    gen = torch.Generator().manual_seed(0)
    pairs = [
        (JT.init_params(jcfg, jax.random.PRNGKey(0)),
         PT.init_params(pcfg, gen)),
        (JT.init_lora(jcfg, jax.random.PRNGKey(0), rank=4),
         PT.init_lora(pcfg, gen, rank=4)),
        (JT.init_cache(jcfg, 3, 8), PT.init_cache(pcfg, 3, 8, device="cpu")),
    ]
    for jtree, ptree in pairs:
        assert _structure(interop.tree_paths(ptree)) == _jax_structure(jtree)
    assert PT.stack_sizes(pairs[0][1]["blocks"]) \
        == JT.stack_sizes(pairs[0][0]["blocks"])
    assert PT.stack_kinds(pcfg) == JT.stack_kinds(jcfg)


def test_unported_block_kinds_raise(test_spec):
    """Every block kind and frontend of the JAX package is ported now, so
    nothing raises: the enc-dec order (whisper-tiny: a frozen ``enc``
    stack with ``enc_norm``, ``dec`` blocks with ``lnx`` and ``cross``,
    LoRA on ``dec`` only, a decode cache without the encoder and with
    ``cross_k``/``cross_v``) and qwen2-vl's vision frontend
    (``vis_proj``) build here, and their parity is in
    ``tests/test_torch_encdec.py`` and ``tests/test_torch_frontend_vlm.py``;
    the hybrid order (``tests/test_torch_hybrid.py``) and MLA
    (deepseek-v3, ``tests/test_torch_mla.py``) as before. (The name is
    the one this test had while the two frontend orders raised.)"""
    spec = ReducedSpec(**dataclasses.asdict(test_spec))
    assert not hasattr(PT, "_check_ported")
    whisper = reduce_config(get_config("whisper-tiny"), spec)
    gen = torch.Generator().manual_seed(0)
    params = PT.init_params(whisper, gen)
    assert sorted(params["blocks"]) == ["dec", "enc"]
    assert "enc_norm" in params and "vis_proj" not in params
    assert {"lnx", "cross"} <= set(params["blocks"]["dec"])
    assert not {"lnx", "cross"} & set(params["blocks"]["enc"])
    assert sorted(PT.init_lora(whisper, gen, rank=4)) == ["dec"]
    cache = PT.init_cache(whisper, 3, 8, device="cpu")
    assert sorted(cache["stacks"]) == ["dec"]
    assert tuple(cache["stacks"]["dec"]["cross_k"].shape) == (
        whisper.n_layers, 3, whisper.n_frontend_tokens,
        whisper.n_kv_heads, whisper.hd)
    qwen_vl = reduce_config(get_config("qwen2-vl-7b"), spec)
    params = PT.init_params(qwen_vl, gen)
    assert tuple(params["vis_proj"].shape) == (qwen_vl.d_model,) * 2
    assert sorted(PT.init_cache(qwen_vl, 1, 8, device="cpu")["stacks"]) \
        == ["layers"]
    jamba = reduce_config(get_config("jamba-v0.1-52b"), spec)
    params = PT.init_params(jamba, torch.Generator().manual_seed(0))
    assert sorted(params["blocks"]) == ["attn_mlp", "mamba_mlp", "mamba_moe"]
    deepseek = reduce_config(get_config("deepseek-v3-671b"), spec)
    params = PT.init_params(deepseek, torch.Generator().manual_seed(0))
    assert sorted(params["blocks"]) == ["dense", "moe"]
    cache = PT.init_cache(deepseek, 1, 8, device="cpu")
    assert sorted(cache["stacks"]["moe"]["mixer"]) == ["c", "k_rope"]


SETUPS = [
    ("qwen2-7b", "2d", "float32"),
    ("qwen2-7b", "per-slot", "float32"),
    ("llama2-7b-proxy", "2d", "float32"),
    ("llama2-7b-proxy", "per-slot", "float32"),
    ("qwen2-7b", "2d", "bfloat16"),      # f32 params, bf16 cache (the CLI)
]


@pytest.mark.parametrize("arch,lora_mode,cache_dtype", SETUPS)
def test_decode_step_matches_jax(arch, lora_mode, cache_dtype, test_spec):
    """Several decode steps from a populated cache with ragged cursors
    (one empty slot): logits every step, then the whole cache."""
    jcfg, pcfg = _cfgs(arch, test_spec, dtype=cache_dtype)
    rng = _rng("decode", arch, lora_mode, cache_dtype)
    b, cap, steps = 3, 8, 4
    params = _np_params(jcfg, rng)
    lora = _np_lora(jcfg, rng, batch=b if lora_mode == "per-slot" else None)
    cache = jax.tree.map(np.asarray, JT.init_cache(jcfg, b, cap,
                                                   jnp.float32))
    cache["stacks"] = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32),
        cache["stacks"])
    cache["pos"] = np.array([3, 0, 6], np.int32)   # slot 2 wraps the ring
    jcache = jax.tree.map(
        lambda a: jnp.asarray(a).astype(cache_dtype)
        if a.dtype == np.float32 else jnp.asarray(a), cache)
    pcache = interop.from_numpy_tree(jax.tree.map(np.asarray, jcache))
    jp, jl = (jax.tree.map(jnp.asarray, t) for t in (params, lora))
    pp, pl = (interop.from_numpy_tree(t) for t in (params, lora))
    step = jax.jit(lambda p, l, t, c: JT.decode_step(jcfg, p, l, t, c))
    tol = F32_TOL if cache_dtype == "float32" else BF16_TOL
    for _ in range(steps):
        tok = rng.integers(0, jcfg.vocab, size=(b, 1)).astype(np.int32)
        jlogits, jcache = step(jp, jl, jnp.asarray(tok), jcache)
        plogits, pcache = PT.decode_step(pcfg, pp, pl, torch.from_numpy(tok),
                                         pcache)
        assert plogits.shape == jlogits.shape
        _close(plogits, jlogits, tol)
    np.testing.assert_array_equal(pcache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))
    for (_, got), want in zip(interop.tree_paths(pcache["stacks"]),
                              jax.tree.leaves(jcache["stacks"])):
        assert str(got.dtype).removeprefix("torch.") == want.dtype.name
        _close(got, want, tol)


def test_decode_step_masks_vocab_padding(test_spec):
    _, pcfg = _cfgs("qwen2-7b", dataclasses.replace(test_spec, vocab=200))
    assert pcfg.padded_vocab > pcfg.vocab
    gen = torch.Generator().manual_seed(0)
    params = PT.init_params(pcfg, gen)
    cache = PT.init_cache(pcfg, 2, 4, device="cpu")
    logits, new = PT.decode_step(pcfg, params, None,
                                 torch.zeros((2, 1), dtype=torch.int64), cache)
    assert bool((logits[..., pcfg.vocab:] == PL.NEG_INF).all())
    assert new["pos"].tolist() == [1, 1] and cache["pos"].tolist() == [0, 0]


# ---------------------------------------------------------------------------
# LoRA utilities
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scaling", [None, 0.5])
def test_merge_lora_matches_jax(scaling, test_spec):
    jcfg, _ = _cfgs("qwen2-7b", test_spec)
    rng = _rng("merge", str(scaling))
    params, lora = _np_params(jcfg, rng), _np_lora(jcfg, rng)
    want = jlora.merge_lora(jax.tree.map(jnp.asarray, params),
                            jax.tree.map(jnp.asarray, lora), scaling)
    got = plora.merge_lora(interop.from_numpy_tree(params),
                           interop.from_numpy_tree(lora), scaling)
    for (_, g), w in zip(interop.tree_paths(got), jax.tree.leaves(want)):
        _close(g, w, F32_TOL)


def test_lora_accounting_matches_jax(test_spec):
    jcfg, _ = _cfgs("qwen2-7b", test_spec)
    lora = _np_lora(jcfg, _rng("bytes"))
    plo = interop.from_numpy_tree(lora)
    assert plora.lora_bytes(plo) == jlora.lora_bytes(lora)
    assert plora.lora_param_count(plo) == jlora.lora_param_count(lora)
    roles = [plora.lora_leaf_role(p) for p, _ in interop.tree_paths(plo)]
    jroles = [jlora.lora_leaf_role(p) for p, _ in
              jax.tree_util.tree_flatten_with_path(lora)[0]]
    assert roles == jroles and set(roles) == {"a", "b"}
    assert plora.lora_leaf_role(("layers", "wq")) is None
