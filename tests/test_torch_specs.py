"""The port's input shapes and meta-tensor specs against the JAX
package's (``repro.configs`` input shapes, ``repro.launch.specs``): for
every arch at full size and every assigned input shape, the same leaf
paths, shapes and dtypes, with nothing allocated (every port leaf is a
``meta`` tensor; JAX's side is ``jax.eval_shape``, abstract too), and the
same ``effective_window``, ``supports_shape`` and cache capacity."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import INPUT_SHAPES as JAX_SHAPES
from repro.configs import LONG_CONTEXT_WINDOW as JAX_LONG_WINDOW
from repro.configs import get_config as jax_get_config
from repro.launch import specs as JS
from repro_torch.configs import (ALL_ARCH_IDS, INPUT_SHAPES,
                                 LONG_CONTEXT_WINDOW, get_config, get_shape)
from repro_torch.launch import specs as S
from repro_torch.models import transformer as T

torch.set_num_threads(1)


def _key(k):
    for attr in ("key", "name", "idx"):
        if hasattr(k, attr):
            return getattr(k, attr)
    raise TypeError(k)


def _jax_leaves(tree):
    return [(tuple(_key(k) for k in path), tuple(leaf.shape),
             str(np.dtype(leaf.dtype)))
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _port_leaves(tree, prefix=()):
    """(path, shape, dtype) per leaf in ``jax.tree.leaves`` order; every
    leaf must be a meta tensor."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree)
                for leaf in _port_leaves(tree[k], prefix + (k,))]
    if hasattr(tree, "_fields"):                      # AdamWState
        return [leaf for k in tree._fields
                for leaf in _port_leaves(getattr(tree, k), prefix + (k,))]
    assert isinstance(tree, torch.Tensor) and tree.device.type == "meta", \
        (prefix, tree)
    return [(prefix, tuple(tree.shape), str(tree.dtype).split(".")[-1])]


def test_input_shapes_match_jax():
    assert LONG_CONTEXT_WINDOW == JAX_LONG_WINDOW
    assert list(INPUT_SHAPES) == list(JAX_SHAPES)
    for name, shape in JAX_SHAPES.items():
        got = get_shape(name)
        assert (got.name, got.seq_len, got.global_batch, got.kind) == (
            shape.name, shape.seq_len, shape.global_batch, shape.kind)


@pytest.mark.parametrize("arch", ALL_ARCH_IDS)
def test_param_lora_opt_specs_match_jax(arch):
    jcfg, pcfg = jax_get_config(arch), get_config(arch)
    assert _port_leaves(S.param_specs(pcfg)) \
        == _jax_leaves(JS.param_specs(jcfg))
    jl, pl = JS.lora_specs(jcfg), S.lora_specs(pcfg)
    assert _port_leaves(pl) == _jax_leaves(jl)
    assert _port_leaves(S.opt_specs(pl)) == _jax_leaves(JS.opt_specs(jl))


@pytest.mark.parametrize("shape", list(INPUT_SHAPES))
@pytest.mark.parametrize("arch", ALL_ARCH_IDS)
def test_shape_specs_match_jax(arch, shape):
    jcfg, pcfg = jax_get_config(arch), get_config(arch)
    jsh, psh = JAX_SHAPES[shape], get_shape(shape)
    assert pcfg.effective_window(psh) == jcfg.effective_window(jsh)
    assert pcfg.supports_shape(psh) == jcfg.supports_shape(jsh)
    for with_labels in (True, False):
        assert _port_leaves(S.batch_specs(pcfg, psh,
                                          with_labels=with_labels)) \
            == _jax_leaves(JS.batch_specs(jcfg, jsh,
                                          with_labels=with_labels))
    assert _port_leaves(S.cache_specs(pcfg, psh)) \
        == _jax_leaves(JS.cache_specs(jcfg, jsh))
    assert _port_leaves(S.token_specs(psh)) \
        == _jax_leaves(JS.token_specs(jsh))
    window = jcfg.effective_window(jsh)
    assert S.cache_capacity(pcfg, psh) == (
        min(jsh.seq_len, window) if window else jsh.seq_len)


def test_specs_leave_the_real_initialisation_unchanged():
    """Building specs draws nothing from any real generator: a seeded
    initialisation gives the same tensors before and after."""
    from repro_torch.configs import ReducedSpec, reduce_config
    cfg = reduce_config(get_config("llama2-7b-proxy"), ReducedSpec())
    before = T.init_params(cfg, torch.Generator().manual_seed(3))
    torch.manual_seed(3)
    state = torch.random.get_rng_state()
    S.param_specs(get_config("llama2-7b-proxy"))
    S.lora_specs(get_config("llama2-7b-proxy"))
    assert torch.equal(state, torch.random.get_rng_state())
    after = T.init_params(cfg, torch.Generator().manual_seed(3))
    for a, b in zip(T.tree_leaves(before), T.tree_leaves(after)):
        assert torch.equal(a, b)
