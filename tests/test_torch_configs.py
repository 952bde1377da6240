"""The PyTorch port's configs and weight bridge against the JAX
package's, and the port's isolation from JAX.

* all 11 arch configs, ``reduce_config`` under both reduced specs, and
  the derived fields equal the JAX package's, field for field;
* ``interop`` moves f32, bf16 and int32 trees bit-exactly in both
  directions, keeping key structure and ``jax.tree.leaves`` order;
* a fresh interpreter imports every ``repro_torch`` module (those of
  the serving and the training paths alike) and ends with no ``jax``,
  ``jaxlib``, ``ml_dtypes`` or ``repro`` module loaded — the port
  stands on torch and numpy alone.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
import repro_torch.configs as pcfgs
from repro_torch import interop

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def _port_spec(spec):
    return pcfgs.ReducedSpec(**dataclasses.asdict(spec))


def test_arch_registry_matches_jax():
    assert pcfgs.ALL_ARCH_IDS == jcfgs.ALL_ARCH_IDS
    assert pcfgs.ARCH_IDS == jcfgs.ARCH_IDS
    with pytest.raises(KeyError):
        pcfgs.get_config("gpt-5")


@pytest.mark.parametrize("arch", jcfgs.ALL_ARCH_IDS)
@pytest.mark.parametrize("reduced", ["full", "default-spec", "test-spec"])
def test_config_matches_jax(arch, reduced, test_spec):
    jc, pc = jcfgs.get_config(arch), pcfgs.get_config(arch)
    if reduced == "default-spec":
        jc, pc = jcfgs.reduce_config(jc), pcfgs.reduce_config(pc)
    elif reduced == "test-spec":
        jc = jcfgs.reduce_config(jc, test_spec)
        pc = pcfgs.reduce_config(pc, _port_spec(test_spec))
    assert pcfgs.shared_fields(pc) == dataclasses.asdict(jc)
    assert (pc.hd, pc.padded_vocab, pc.layer_stacks()) \
        == (jc.hd, jc.padded_vocab, jc.layer_stacks())


def test_kernel_backend_values_load_unchanged():
    """A config written by the JAX package (any of its three backends)
    is a valid port config; "pallas" names the Hopper kernels here."""
    from repro_torch.kernels import dispatch
    for backend in ("pallas", "reference", "auto"):
        cfg = dataclasses.replace(pcfgs.get_config("qwen2-7b"),
                                  kernel_backend=backend)
        assert dispatch.canonical(cfg.kernel_backend) == backend
    assert pcfgs.pad_vocab(152064) == jcfgs.pad_vocab(152064)
    assert pcfgs.pad_vocab(32001) == jcfgs.pad_vocab(32001) == 32128


# ---------------------------------------------------------------------------
# interop
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_interop_roundtrip_is_bit_exact(dtype):
    rng = np.random.default_rng(np.random.SeedSequence((17, len(dtype))))
    raw = (rng.standard_normal((3, 5)) * 1e3).astype(np.float32)
    if dtype == "int32":
        raw = rng.integers(-2**31, 2**31 - 1, size=(3, 5), dtype=np.int32)
    arr = np.asarray(jnp.asarray(raw).astype(dtype))   # as JAX hands it out
    tree = {"z": arr, "a": {"b": arr[:2], "c": [arr[0], arr[1:]]}}
    tt = interop.from_numpy_tree(tree)
    assert tt["z"].dtype == getattr(torch, dtype)
    # torch sees the same values (bf16 checked through f32, which is exact)
    np.testing.assert_array_equal(tt["z"].float().numpy(),
                                  arr.astype(np.float32))
    back = interop.to_numpy_tree(tt)
    for got, want in zip(interop.tree_leaves(back), jax.tree.leaves(tree)):
        assert got.dtype == want.dtype
        assert got.tobytes() == want.tobytes()
    # the port's tensors own their memory: writing them leaves JAX's be
    tt["z"].zero_()
    assert np.array_equal(arr, tree["z"]) and arr.any()


def test_interop_tree_order_matches_jax():
    tree = {"blocks": {"layers": {"wq": np.zeros(1), "ln1": np.ones(2)}},
            "embed": np.zeros(3), "final_norm": np.zeros(4)}
    assert [a.shape for a in interop.tree_leaves(tree)] \
        == [a.shape for a in jax.tree.leaves(tree)]
    assert [p for p, _ in interop.tree_paths(tree)] == [
        tuple(k.key for k in path)
        for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def test_interop_scalars_pass_through():
    tree = {"a": np.ones((2, 2), np.float32), "alpha": 16.0}
    out = interop.from_numpy_tree(tree)
    assert out["alpha"] == 16.0 and isinstance(out["a"], torch.Tensor)
    assert interop.to_numpy_tree(out)["alpha"] == 16.0


# ---------------------------------------------------------------------------
# import isolation
# ---------------------------------------------------------------------------

_ISOLATION = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "ml_dtypes", "repro",
                                    "msgpack"))
print(len(names), bad, ",".join(names))
assert not bad, bad
"""

#: modules of each ported path that the isolation check must reach
PORTED_MODULES = {
    # serving
    "repro_torch.kernels.flash_decode", "repro_torch.launch.serve",
    "repro_torch.serving.engine",
    # training
    "repro_torch.data.synthetic", "repro_torch.optim.adamw",
    "repro_torch.optim.schedule", "repro_torch.kernels.lora_matmul",
    "repro_torch.kernels.flash_attention", "repro_torch.kernels.ops",
    "repro_torch.federated.client", "repro_torch.federated.aggregation",
    "repro_torch.launch.steps",
    # DevFT on Mamba-2
    "repro_torch.kernels.ssd_scan", "repro_torch.models.mamba2",
    # the other five methods, sweeps, checkpoints
    "repro_torch.federated.methods.fedsa",
    "repro_torch.federated.methods.flora",
    "repro_torch.federated.methods.progfed",
    "repro_torch.federated.methods.dofit",
    "repro_torch.federated.methods.c2a",
    "repro_torch.experiments.sweep", "repro_torch.checkpoint",
    "repro_torch.checkpoint.checkpoint",
    # MoE and Mamba-2 decoding, the hybrid order
    "repro_torch.models.transformer", "repro_torch.models.moe",
    "repro_torch.serving.kv_cache", "repro_torch.serving.adapters",
    # the lint and contract layer
    "repro_torch.analysis", "repro_torch.analysis.__main__",
    "repro_torch.analysis.rules.r002_mask_constants",
    "repro_torch.analysis.contracts.kernels",
    "repro_torch.analysis.contracts.strategies",
    "repro_torch.analysis.contracts.serving",
}


def test_port_imports_no_jax_and_no_repro():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO / "src")
    out = subprocess.run([sys.executable, "-c", _ISOLATION],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 46, out.stdout       # every subpackage was walked
    walked = set(out.stdout.split()[-1].split(","))
    assert PORTED_MODULES <= walked, PORTED_MODULES - walked


def test_ported_kinds_reach_mamba2_for_training_only():
    """Every block kind of every config in the repo is ported, for
    training and decoding alike, so the port keeps no check that refuses
    one: the enc-dec order (whisper-tiny: ``enc``/``dec``) and the
    multimodal frontend (qwen2-vl: ``gqa_mlp`` with M-RoPE) joined
    mamba2-2.7b, granite-moe-1b-a400m, jamba-v0.1-52b and
    deepseek-v3-671b, and ``PORTED_KINDS`` is the set of kinds the JAX
    package's ``stack_kinds`` gives over all of them. (The name is the
    one this test had while only training was ported.)"""
    from repro.models import transformer as JT
    from repro_torch.models import transformer as T
    cfg = pcfgs.get_config("mamba2-2.7b")
    assert T.stack_kinds(cfg) == {"layers": "mamba_only"}
    assert not hasattr(T, "_check_ported")
    assert set(T.stack_kinds(pcfgs.get_config("jamba-v0.1-52b")).values()) \
        == {"mamba_mlp", "mamba_moe", "gqa_mlp"}
    assert T.stack_kinds(pcfgs.get_config("deepseek-v3-671b")) \
        == {"dense": "mla_mlp", "moe": "mla_moe"}
    assert T.stack_kinds(pcfgs.get_config("whisper-tiny")) \
        == {"enc": "enc", "dec": "dec"}
    jax_kinds = set()
    for arch in jcfgs.ALL_ARCH_IDS:
        kinds = JT.stack_kinds(jcfgs.get_config(arch))
        assert T.stack_kinds(pcfgs.get_config(arch)) == kinds, arch
        jax_kinds |= set(kinds.values())
    assert set(T.PORTED_KINDS) == jax_kinds
