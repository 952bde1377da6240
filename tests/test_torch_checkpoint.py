"""The port's checkpoint format against the JAX package's
``repro.checkpoint``: the same tree gives the same file, byte for byte;
each package restores the other's file bit-exactly; mismatched
templates raise; the port's msgpack encoder picks the same forms as
``msgpack.packb(..., use_bin_type=True)`` at every size boundary (the
port itself has no msgpack: the library is used here only); and the
port's training CLI writes a ``.ckpt`` that both packages restore.
Everything is compared exactly.
"""
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro_torch import checkpoint as pckpt
from repro_torch import interop
from repro_torch.checkpoint.checkpoint import packb, unpackb

torch.set_num_threads(1)


def _tree(seed=0):
    """Nested dicts of f32, bf16, int32 and 0-d leaves (numpy; bf16
    through JAX's dtype), with keys given out of order."""
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.standard_normal(s, dtype=np.float32)  # noqa: E731
    return {
        "lora": {"layers": {
            "wv": {"b": f32(2, 4, 6), "a": f32(2, 5, 4)},
            "wq": {"a": f32(2, 5, 4), "b": f32(2, 4, 6)}}},
        "step": np.array(7, dtype=np.int32),
        "emb": np.asarray(jnp.asarray(f32(3, 17), dtype=jnp.bfloat16)),
        "ids": rng.integers(-5, 5, (4,), dtype=np.int32),
        "scale": np.array(0.5, dtype=np.float32),
    }


def _bits(x):
    arr = np.asarray(x)
    return arr.dtype.name, arr.shape, arr.tobytes()


def _same_bits(got_tree, want_tree):
    got = [_bits(interop.to_numpy_tree(t)) for t in
           interop.tree_leaves(got_tree)]
    want = [_bits(t) for t in jax.tree.leaves(want_tree)]
    assert got == want


def test_save_is_byte_identical_to_jax(tmp_path):
    tree = _tree()
    jckpt.save(str(tmp_path / "jax.ckpt"), jax.tree.map(jnp.asarray, tree))
    pckpt.save(str(tmp_path / "port.ckpt"), interop.from_numpy_tree(tree))
    want = (tmp_path / "jax.ckpt").read_bytes()
    assert (tmp_path / "port.ckpt").read_bytes() == want
    # numpy leaves pass through unconverted, as the JAX side takes them
    pckpt.save(str(tmp_path / "np.ckpt"), tree)
    assert (tmp_path / "np.ckpt").read_bytes() == want
    payload = msgpack.unpackb(want, raw=False)
    assert payload["treedef"] == str(jax.tree.structure(tree))
    assert not [f for f in os.listdir(tmp_path) if f.startswith("tmp")]


def test_each_package_restores_the_others_file(tmp_path):
    tree = _tree(1)
    ptree = interop.from_numpy_tree(tree)
    pckpt.save(str(tmp_path / "port.ckpt"), ptree)
    jtree = jax.tree.map(jnp.asarray, tree)
    back = jckpt.restore(str(tmp_path / "port.ckpt"), jtree)
    _same_bits(ptree, back)
    jckpt.save(str(tmp_path / "jax.ckpt"), jtree)
    template = interop.tree_map(torch.zeros_like, ptree)
    got = pckpt.restore(str(tmp_path / "jax.ckpt"), template)
    _same_bits(got, jtree)
    assert list(got) == list(template)            # the template's order
    assert got["emb"].dtype == torch.bfloat16
    assert got["step"].shape == () and got["step"].dtype == torch.int32


def test_restore_checks_the_template(tmp_path):
    tree = interop.from_numpy_tree(_tree(2))
    path = str(tmp_path / "t.ckpt")
    pckpt.save(path, tree)
    bad_shape = interop.tree_map(torch.zeros_like, tree)
    bad_shape["lora"]["layers"]["wq"]["a"] = torch.zeros(2, 5, 3)
    with pytest.raises(ValueError, match="shape"):
        pckpt.restore(path, bad_shape)
    fewer = interop.tree_map(torch.zeros_like, tree)
    del fewer["ids"]
    with pytest.raises(ValueError, match="leaves"):
        pckpt.restore(path, fewer)
    with pytest.raises(TypeError):                # not an array leaf
        pckpt.save(str(tmp_path / "none.ckpt"), {"a": None})
    assert not (tmp_path / "none.ckpt").exists()


@pytest.mark.parametrize("n", [0, 1, 15, 16, 31, 32, 127, 128, 255, 256,
                               65535, 65536])
def test_encoder_matches_msgpack_at_size_boundaries(n):
    objs = [{f"k{i}": i for i in range(n)}, list(range(n)), "s" * n,
            b"\x00" * n, n, {"nested": [{"x": b"\x01" * n}, "é" * n]}]
    for obj in objs:
        want = msgpack.packb(obj, use_bin_type=True)
        assert packb(obj) == want, (type(obj), n)
        assert unpackb(want) == msgpack.unpackb(want, raw=False)
    for big in (2 ** 32 - 1, 2 ** 32, 2 ** 64 - 1):
        assert packb(big) == msgpack.packb(big, use_bin_type=True)
    with pytest.raises(TypeError):
        packb(-1)
    with pytest.raises(ValueError):
        unpackb(msgpack.packb(None))
    with pytest.raises(ValueError):
        unpackb(msgpack.packb(1) + b"\x00")


def test_train_cli_writes_a_checkpoint_jax_restores(tmp_path):
    """The CLI's ``.ckpt`` (in process, at a tiny size; the bench-tiny
    CLI run is ``tests/test_torch_runner.py::test_cli_runs_on_the_cpu``)
    reads the same in both packages."""
    from repro_torch.launch import train
    assert train.main(["--device", "cpu", "--preset", "bench-tiny",
                       "--rounds", "1", "--pretrain-steps", "0",
                       "--layers", "1", "--seq", "8", "--local-batch", "2",
                       "--k-local", "1", "--method", "fedsa",
                       "--out", str(tmp_path)]) == 0
    names = sorted(os.listdir(tmp_path))
    assert names == ["llama2-7b-proxy_fedsa_s0.ckpt",
                     "llama2-7b-proxy_fedsa_s0.json",
                     "llama2-7b-proxy_fedsa_s0.result.json"]
    path = str(tmp_path / names[0])
    payload = msgpack.unpackb(Path(path).read_bytes(), raw=False)
    assert payload["paths"] == [f"['lora']['layers']['{t}']['{f}']"
                                for t in ("wq", "wv") for f in "ab"]
    template = {"lora": {"layers": {
        t: {f: jnp.zeros(tuple(leaf["s"]), jnp.float32)
            for f, leaf in zip("ab", payload["leaves"][2 * i:2 * i + 2])}
        for i, t in enumerate(("wq", "wv"))}}}
    back = jckpt.restore(path, template)
    assert [np.asarray(l).dtype for l in jax.tree.leaves(back)] \
        == [np.float32] * 4
    mine = pckpt.restore(path, interop.from_numpy_tree(
        jax.tree.map(np.asarray, template)))
    _same_bits(mine, back)
