"""The PyTorch port's Mamba-2 block (``models/mamba2.py``) and the
``mamba_only`` model against the JAX package, on reduced mamba2-2.7b
(d 128, d_inner 256, 8 heads of 32, N 16, G 1, chunk 32).

Parameters always cross from the JAX package through numpy (JAX seeds
them with ``jax.random``), with a non-zero LoRA on in_proj and out_proj.

* ``init_mamba`` / ``init_params``: the same leaves, shapes and dtypes
  (``dt_bias``, ``A_log`` and ``D`` f32 beside bf16 weights).
* ``mamba_forward``, f32, at S a whole number of chunks (64), ragged
  (40) and shorter than one chunk (16): the plain branch against JAX's
  ``reference`` backend at 1e-4 (rtol = atol; summation order through
  the two projections and the scan), and the kernel branch — forced on
  the CPU by making ``dispatch.use_kernel`` true, so the ``ssd_scan``
  and ``lora_matmul`` autograd Functions run their plain versions —
  against JAX's ``pallas`` backend in interpret mode at 1e-3, the JAX
  package's own limit for its SSD kernel.
* The whole model's loss and every LoRA gradient against
  ``jax.value_and_grad`` at rel = abs = 1e-4, the limit the JAX package
  holds its own two backends to (``tests/test_kernel_dispatch.py``),
  through both branches.
* ``prefill``'s last-token logits, f32, at 1e-4.
* ``init_cache`` and ``decode_step`` on ``mamba_only`` blocks run (their
  parity with the JAX package is ``tests/test_torch_decode_mamba.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduce_config as jax_reduce_config
from repro.models import mamba2 as JMb
from repro.models import transformer as JT
from repro_torch import interop
from repro_torch.configs import ReducedSpec, get_config, reduce_config
from repro_torch.kernels import dispatch
from repro_torch.models import mamba2 as PMb
from repro_torch.models import transformer as PT

torch.set_num_threads(1)

ARCH = "mamba2-2.7b"


def _cfgs(test_spec, backend="reference", dtype="float32"):
    jcfg = jax_reduce_config(jax_get_config(ARCH), test_spec)
    pcfg = reduce_config(get_config(ARCH),
                         ReducedSpec(**dataclasses.asdict(test_spec)))
    jb = "pallas" if backend == "kernel" else "reference"
    pb = "auto" if backend == "kernel" else "reference"
    return (dataclasses.replace(jcfg, dtype=dtype, kernel_backend=jb),
            dataclasses.replace(pcfg, dtype=dtype, kernel_backend=pb))


@pytest.fixture
def forced_kernel_branch(monkeypatch):
    """Every kernel branch of the port taken on the CPU: the autograd
    Functions then resolve to their plain versions."""
    calls = []

    def use_kernel(backend, device):
        calls.append(backend)
        return True
    monkeypatch.setattr(dispatch, "use_kernel", use_kernel)
    return calls


def _nonzero_lora(jcfg, rank=4, seed=11):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (0.05 * rng.standard_normal(a.shape)).astype(np.float32),
        JT.init_lora(jcfg, jax.random.PRNGKey(1), rank=rank))


def test_init_leaves_shapes_and_dtypes_match_jax(test_spec):
    for dtype in ("float32", "bfloat16"):
        jcfg, pcfg = _cfgs(test_spec, dtype=dtype)
        jp = JMb.init_mamba(jax.random.PRNGKey(0), jcfg, jnp.dtype(dtype))
        pp = PMb.init_mamba(torch.Generator().manual_seed(0), pcfg,
                            getattr(torch, dtype))
        assert sorted(pp) == sorted(jp)
        for k in jp:
            assert tuple(pp[k].shape) == jp[k].shape, k
            assert str(pp[k].dtype).split(".")[-1] == jp[k].dtype.name, k
        for k in ("A_log", "D", "dt_bias", "conv_b", "out_norm"):
            np.testing.assert_allclose(pp[k].float().numpy(),
                                       np.asarray(jp[k], np.float32),
                                       rtol=1e-6, atol=1e-7)
        jfull = JT.init_params(jcfg, jax.random.PRNGKey(0))
        pfull = PT.init_params(pcfg, torch.Generator().manual_seed(0))
        jpaths = [(tuple(k.key for k in p), leaf.shape, leaf.dtype.name)
                  for p, leaf in jax.tree_util.tree_flatten_with_path(
                      jfull)[0]]
        ppaths = [(p, tuple(t.shape), str(t.dtype).split(".")[-1])
                  for p, t in interop.tree_paths(pfull)]
        assert ppaths == jpaths
    # the LoRA targets: in_proj d -> 2 d_inner + 2 G N + H, out_proj
    full = get_config(ARCH)
    assert PT._block_lora_targets(full, "mamba_only") == {
        "in_proj": (2560, 10576), "out_proj": (5120, 2560)}


@pytest.mark.parametrize("seq", [64, 40, 16], ids=["whole", "ragged",
                                                   "short"])
@pytest.mark.parametrize("branch", ["plain", "kernel"])
def test_mamba_forward_matches_jax(seq, branch, test_spec, request):
    jcfg, pcfg = _cfgs(test_spec, backend=branch)
    if branch == "kernel":
        calls = request.getfixturevalue("forced_kernel_branch")
    params = jax.tree.map(np.asarray, JMb.init_mamba(
        jax.random.PRNGKey(3), jcfg, jnp.float32))
    lora = _nonzero_lora(jcfg)["layers"]
    lora = jax.tree.map(lambda a: a[0], lora)           # one layer
    u = np.random.default_rng(seq).standard_normal(
        (2, seq, jcfg.d_model)).astype(np.float32)
    want = JMb.mamba_forward(jax.tree.map(jnp.asarray, params), jcfg,
                             jnp.asarray(u), lora=jax.tree.map(jnp.asarray,
                                                               lora))
    got = PMb.mamba_forward(interop.from_numpy_tree(params), pcfg,
                            torch.from_numpy(u),
                            lora=interop.from_numpy_tree(lora))
    assert got.shape == u.shape and got.dtype == torch.float32
    tol = 1e-3 if branch == "kernel" else 1e-4
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)
    if branch == "kernel":
        assert calls == ["auto"] * 3       # in_proj, ssd_scan, out_proj


def _setup(jcfg, batch=2, seq=40):
    rng = np.random.default_rng(5)
    params = jax.tree.map(np.asarray,
                          JT.init_params(jcfg, jax.random.PRNGKey(0),
                                         jnp.float32))
    tokens = rng.integers(0, jcfg.vocab, (batch, seq)).astype(np.int32)
    labels = rng.integers(0, jcfg.vocab, (batch, seq)).astype(np.int32)
    labels[1, 2] = -1
    return params, _nonzero_lora(jcfg), {"tokens": tokens, "labels": labels}


@pytest.mark.parametrize("branch", ["plain", "kernel"])
def test_loss_and_lora_grads_match_jax(branch, test_spec, request):
    jcfg, pcfg = _cfgs(test_spec, backend=branch)
    if branch == "kernel":
        calls = request.getfixturevalue("forced_kernel_branch")
    params, lora, batch = _setup(jcfg)
    (jt, jm), jg = jax.value_and_grad(
        lambda lo: JT.loss_fn(jcfg, jax.tree.map(jnp.asarray, params), lo,
                              jax.tree.map(jnp.asarray, batch)),
        has_aux=True)(jax.tree.map(jnp.asarray, lora))
    pt, pm, pg = PT.loss_and_lora_grads(pcfg,
                                        interop.from_numpy_tree(params),
                                        interop.from_numpy_tree(lora), batch)
    for g, w in [(pt, jt)] + [(pm[k], jm[k]) for k in ("loss", "aux", "acc")]:
        np.testing.assert_allclose(float(g), float(w), rtol=1e-4, atol=1e-4)
    paths = interop.tree_paths(pg)
    assert [p for p, _ in paths] == [
        tuple(k.key for k in path)
        for path, _ in jax.tree_util.tree_flatten_with_path(jg)[0]]
    assert {p[-2] for p, _ in paths} == {"in_proj", "out_proj"}
    for (_, g), w in zip(paths, jax.tree.leaves(jg)):
        assert float(np.abs(np.asarray(w)).max()) > 0
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)
    if branch == "kernel":
        assert calls == ["auto"] * 3 * pcfg.n_layers


def test_prefill_logits_match_jax(test_spec):
    jcfg, pcfg = _cfgs(test_spec)
    params, lora, batch = _setup(jcfg, seq=24)
    want = JT.prefill(jcfg, jax.tree.map(jnp.asarray, params),
                      jax.tree.map(jnp.asarray, lora),
                      jax.tree.map(jnp.asarray, batch))
    got = PT.prefill(pcfg, interop.from_numpy_tree(params),
                     interop.from_numpy_tree(lora), batch)
    assert tuple(got.shape) == want.shape == (2, 1, pcfg.padded_vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_mamba_decode_is_not_ported(test_spec):
    """The Mamba-2 decode path runs: the cache is ``mamba_only``'s
    unwrapped ``{conv, ssm}`` (``ssm`` f32), ``decode_step`` advances
    both leaves and the cursor, and its logits are finite. (The name is
    the one this test had while Mamba decoding still raised.)"""
    _, pcfg = _cfgs(test_spec)
    params = PT.init_params(pcfg, torch.Generator().manual_seed(0))
    cache = PT.init_cache(pcfg, 2, 8, device="cpu")
    stack = cache["stacks"]["layers"]
    assert sorted(stack) == ["conv", "ssm"]
    assert stack["ssm"].dtype == torch.float32
    assert tuple(stack["conv"].shape) == (
        pcfg.n_layers, 2, pcfg.mamba.conv_width - 1, PMb.conv_dim(pcfg))
    logits, new = PT.decode_step(pcfg, params, None,
                                 torch.tensor([[1], [2]]), cache)
    assert tuple(logits.shape) == (2, 1, pcfg.padded_vocab)
    assert bool(torch.isfinite(logits[..., :pcfg.vocab]).all())
    assert new["pos"].tolist() == [1, 1]
    assert new["stacks"] is cache["stacks"]
    assert stack["conv"].any() and stack["ssm"].any()
