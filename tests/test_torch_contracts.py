"""The port's contract layer (``python -m repro_torch.analysis
--contracts``) on the CPU.

* **the surface is clean**: one driver run over every registered kernel
  × backend × shape family (meta tensors: the plain versions and the
  dry-run's stand-ins), strategy × preset × fleet × policy (round
  programs on meta tensors) and serving family × adapter mode returns
  zero findings;
* **enumeration is total**: the stats equal the registry sizes computed
  independently;
* **parity with the JAX package**: the shape families, the fleet ×
  policy cells and their deduplication, and each strategy's uplink byte
  count equal the JAX package's;
* **injected drift is caught**: an upcasting plain kernel (C001), an
  aggregate that reshapes a leaf or returns a tensor uplink (C002), a
  decode step that changes a cache leaf's dtype (C003);
* the sync guard nests and puts back the mode it found.
"""
import warnings

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.analysis.contracts import shapes as jax_shapes
from repro.analysis.contracts import strategies as jax_strategies
from repro_torch.analysis import guard_syncs, no_implicit_syncs
from repro_torch.analysis import tracing
from repro_torch.analysis.contracts import run_contracts, shapes
from repro_torch.analysis.contracts import strategies as cstrat
from repro_torch.analysis.contracts.base import leaf_mismatches
from repro_torch.analysis.contracts.kernels import check_kernels
from repro_torch.analysis.contracts.serving import (ARCH_FAMILIES, MODES,
                                                    check_serving)
from repro_torch.kernels import dispatch

pytestmark = pytest.mark.analysis

torch.set_num_threads(1)

PRESET = "bench-tiny"        # the preset of the uplink parity cells


@pytest.fixture(scope="module")
def contracts():
    """One whole driver run on meta, shared by the clean-surface and
    enumeration tests."""
    return run_contracts()


# ---------------------------------------------------------------------------
# the whole CPU surface is clean, and its enumeration total
# ---------------------------------------------------------------------------


def test_whole_surface_is_clean(contracts):
    findings, _ = contracts
    assert findings == [], "\n".join(f.render() for f in findings)


def test_kernel_enumeration_is_total(contracts):
    _, stats = contracts
    reg = dispatch.available_kernels()
    decls = dispatch.kernel_contracts()
    assert set(reg) == set(decls) and len(reg) == 5
    assert all(b == ["pallas", "reference"] for b in reg.values())
    assert stats["kernels"] == 5
    # meta: pallas, reference, auto on the plain versions, then pallas and
    # auto on the stand-ins
    assert stats["kernel_surfaces"] == 5 * (3 + 2)
    n_cases = sum(len(list(shapes.kernel_cases(decls[n].family)))
                  for n in reg)
    assert n_cases == 9
    assert stats["kernel_calls"] == 5 * n_cases


def test_strategy_enumeration_is_total(contracts):
    from repro_torch.experiments.presets import available_presets
    from repro_torch.federated.heterogeneity import (POLICIES,
                                                     available_fleets)
    from repro_torch.federated.methods.registry import available_methods

    _, stats = contracts
    methods, presets = available_methods(), available_presets()
    assert stats["strategies"] == len(methods) == 7
    assert stats["strategy_presets"] == len(methods) * len(presets)
    assert stats["strategy_cells"] == (len(methods) * len(presets)
                                       * len(available_fleets())
                                       * len(POLICIES))
    assert stats["strategy_programs"] >= 2 * len(methods)


def test_serving_enumeration_is_total(contracts):
    _, stats = contracts
    assert stats["serving_families"] == len(ARCH_FAMILIES) == 3
    assert stats["serving_steps"] == len(ARCH_FAMILIES) * len(MODES) == 9


def test_kernels_hold_on_real_cpu_tensors():
    findings, stats = check_kernels("cpu")
    assert findings == []
    assert stats["kernel_calls"] == 3 * 9        # pallas, reference, auto


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------


def _described(cases, dtype_name):
    def one(x):
        if hasattr(x, "shape") and hasattr(x, "dtype"):
            return tuple(x.shape), dtype_name(x.dtype)
        return x
    return [(tag, [(k, one(v)) for k, v in args.items()],
             sorted((k, one(v)) for k, v in kwargs.items()))
            for tag, args, kwargs in cases]


@pytest.mark.parametrize("family", sorted(jax_shapes.FAMILIES))
def test_shape_families_equal_jax(family):
    assert sorted(shapes.FAMILIES) == sorted(jax_shapes.FAMILIES)
    ours = _described(shapes.kernel_cases(family),
                      lambda d: str(d).replace("torch.", ""))
    theirs = _described(jax_shapes.kernel_cases(family),
                        lambda d: jnp.dtype(d).name)
    assert ours == theirs


def test_hetero_cells_equal_jax():
    from repro.experiments.presets import available_presets as jpresets
    from repro.experiments.presets import get_preset as jget_preset
    from repro.federated.heterogeneity import POLICIES as JPOLICIES
    from repro.federated.heterogeneity import available_fleets as jfleets
    from repro_torch.experiments.presets import available_presets, get_preset
    from repro_torch.federated.heterogeneity import (POLICIES,
                                                     available_fleets)

    assert available_presets() == jpresets()
    assert available_fleets() == jfleets() and POLICIES == JPOLICIES
    for preset in available_presets():
        ours = cstrat._hetero_cells(get_preset(preset).fed_config(),
                                    available_fleets(), POLICIES)
        theirs = jax_strategies._hetero_cells(
            jget_preset(preset).fed_config(), jfleets(), JPOLICIES)
        assert ours == theirs, preset
        assert len(ours) == len(theirs)           # distinct programs


def _first_cell(make, get_preset, init, method):
    """(strategy, state, sub-spec, fed, n_sample) at ``PRESET``'s first
    stage."""
    spec = get_preset(PRESET).replace(method=method)
    cfg, fed = spec.build_cfg(), spec.fed_config()
    params, lora = init(cfg, fed)
    strategy = make(method, cfg, fed)
    state = strategy.init_state(params, strategy.init_lora(params, lora))
    strategy.on_stage(state, strategy.build_rounds(state)[0][0])
    n_sample = max(1, int(fed.n_clients * fed.sample_frac))
    return strategy, state, strategy.local_spec(state), fed, n_sample


def _jax_init(cfg, fed):
    from repro.models import transformer as JT
    key = jax.random.PRNGKey(fed.seed)
    return (JT.init_params(cfg, key, jnp.float32),
            JT.init_lora(cfg, jax.random.fold_in(key, 1),
                         rank=fed.lora_rank))


def test_uplink_bytes_equal_jax():
    from repro.experiments.presets import get_preset as jget_preset
    from repro.federated.methods.registry import available_methods as jmethods
    from repro.federated.methods.registry import make_strategy as jmake
    from repro_torch.experiments.presets import get_preset
    from repro_torch.federated.methods.registry import (available_methods,
                                                        make_strategy)

    assert available_methods() == jmethods()
    runs = {}
    for method in available_methods():
        st, state, spec_l, fed, n = _first_cell(
            make_strategy, get_preset, cstrat._init_model, method)
        _, up, _ = cstrat._trace_round(st, state, spec_l, fed, n, False,
                                       runs)
        jst, jstate, jspec_l, jfed, jn = _first_cell(
            jmake, jget_preset, _jax_init, method)
        _, jaux, _ = jax_strategies._trace_round(jst, jstate, jspec_l,
                                                 jfed, jn, False)
        assert type(up) is int, method
        assert up == int(jaux["up"]) > 0, method


# ---------------------------------------------------------------------------
# injected drift is caught
# ---------------------------------------------------------------------------


def test_injected_kernel_upcast_is_caught(monkeypatch):
    # the plain lora_matmul upcasts at the bench's 4x case: every backend
    # that resolves to the plain version on meta (pallas, reference,
    # auto) reports it once, the stand-ins and the other case not at all
    plain = dispatch._KERNELS["lora_matmul"]["reference"]

    def upcast(x, w, a, b, *, scaling=1.0):
        out = plain(x, w, a, b, scaling=scaling)
        return out.double() if x.shape[0] == 512 else out

    monkeypatch.setitem(dispatch._KERNELS["lora_matmul"], "reference",
                        upcast)
    findings, _ = check_kernels()
    assert sorted(f.line_text for f in findings) == [
        f"kernel:lora_matmul:{b}:meta:m512_k128_n128_r8"
        for b in ("auto", "pallas", "reference")]
    assert all(f.rule == "C001" and "float64" in f.message
               for f in findings)


def _drift_strategy(reshape: bool, tensor_up: bool):
    from repro_torch.federated.methods import Strategy, register
    from repro_torch.federated.methods.base import AggregateContract

    @register("tmp-drift")
    class Drift(Strategy):
        contract = AggregateContract()

        def aggregate(self, state, spec, client_loras, n_sample,
                      weights=None):
            new, up = super().aggregate(state, spec, client_loras,
                                        n_sample, weights=weights)
            if reshape:
                a = new["layers"]["wq"]["a"]
                new["layers"]["wq"]["a"] = a.reshape(a.shape[0], -1)
            if tensor_up:
                up = torch.tensor(up)
            return new, up
    return Drift


@pytest.mark.parametrize("drift", ["reshape", "tensor_up"])
def test_injected_aggregate_drift_is_caught(drift):
    from repro_torch.experiments.presets import get_preset
    from repro_torch.federated.methods.registry import (make_strategy,
                                                        unregister)

    cls = _drift_strategy(drift == "reshape", drift == "tensor_up")
    try:
        st, state, spec_l, fed, n = _first_cell(
            make_strategy, get_preset, cstrat._init_model, "tmp-drift")
        one = cstrat._check_round(cls.contract, st, state, spec_l, fed, n,
                                  False, "strategy:tmp-drift:cell", {})
    finally:
        unregister("tmp-drift")
    assert len(one) == 1 and one[0].rule == "C002"
    want = "drifts from the global" if drift == "reshape" else "Python int"
    assert want in one[0].message


def test_injected_cache_dtype_drift_is_caught(monkeypatch):
    # one arch family in one mode gets a decode step whose cache cursor
    # turns float: exactly that surface reports it
    from repro_torch.models import transformer as T

    step = T.decode_step

    def drifting(cfg, params, lora, tokens, cache, **kw):
        logits, new = step(cfg, params, lora, tokens, cache, **kw)
        if cfg.arch_id == "qwen2-7b" and lora is None:
            new = dict(new, pos=new["pos"].float())
        return logits, new

    monkeypatch.setattr(T, "decode_step", drifting)
    findings, stats = check_serving()
    assert stats["serving_steps"] == 9
    assert len(findings) == 1 and findings[0].rule == "C003"
    assert findings[0].line_text == "serving:qwen2-7b:base:meta"
    assert "['pos']" in findings[0].message


def test_leaf_mismatches_report_shape_dtype_and_structure():
    def t(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")

    a = {"x": t(2, 3)}
    assert leaf_mismatches(a, {"x": t(2, 3)}) == []
    assert any("[2, 4]" in m for m in leaf_mismatches(a, {"x": t(2, 4)}))
    assert any("int32" in m for m in leaf_mismatches(
        a, {"x": t(2, 3, dtype=torch.int32)}))
    assert leaf_mismatches(a, {"y": t(2, 3)})
    assert leaf_mismatches(a, {"x": 3})


# ---------------------------------------------------------------------------
# the sync guard
# ---------------------------------------------------------------------------


def test_sync_guards_are_noops_without_cuda():
    assert not torch.cuda.is_available()
    with guard_syncs("warn") as record, no_implicit_syncs():
        torch.ones(3).sum().item()
    assert record.count == 0
    with pytest.raises(ValueError):
        with guard_syncs("loud"):
            pass


def test_sync_guards_nest_and_restore(monkeypatch):
    # a stand-in for the card's sync-debug mode: the guard's own logic
    mode = {"now": 0}
    names = {"default": 0, "warn": 1, "error": 2}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode",
                        lambda: mode["now"])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode",
                        lambda m: mode.update(now=names.get(m, m)))
    with guard_syncs("warn") as outer:
        assert mode["now"] == 1
        warnings.warn(f"x {tracing._SYNC_TEXT}")
        with no_implicit_syncs() as inner:
            assert mode["now"] == 2
        assert mode["now"] == 1
        with pytest.warns(UserWarning, match="unrelated"):
            with guard_syncs("warn"):
                warnings.warn("unrelated")      # issued again after
        warnings.warn(f"y {tracing._SYNC_TEXT}")
    assert mode["now"] == 0
    assert outer.count == 2 and inner.count == 0
    with pytest.raises(RuntimeError):
        with guard_syncs("error"):
            raise RuntimeError("inside")
    assert mode["now"] == 0
