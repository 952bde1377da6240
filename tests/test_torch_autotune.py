"""Plan autotuning of the Hopper kernels (``repro_torch.kernels.autotune``
and ``dispatch``'s tuning cache), on the CPU: the cache's JSON round
trip, its keying by device name and source hash, candidates filtered by
each ``plan``'s own refusals, default-first selection under an injected
timer, dispatch consulting the cache for a (faked) CUDA resolution only
and raising on an entry the plan refuses; and ``launch.env``'s
``setup_environment`` on the CPU. The timings themselves are taken only
on the card (``chip_smoke.py``'s autotune phase)."""
import functools
import importlib
import itertools
import json
import os

import pytest
import torch

from repro_torch.kernels import autotune, dispatch, moe_ffn, tuning
from repro_torch.kernels.autotune import DEFAULTS, TUNABLES, TuningCache
from repro_torch.launch.env import setup_environment

torch.set_num_threads(1)

# the package re-exports the op functions under these names
fa = importlib.import_module("repro_torch.kernels.flash_attention")
fd = importlib.import_module("repro_torch.kernels.flash_decode")

BF16 = torch.bfloat16
DEVICE = "NVIDIA H100 80GB HBM3"


@pytest.fixture(autouse=True)
def _isolate_dispatch_cache(monkeypatch):
    """No test leaves a cache installed or reads an on-disk one."""
    monkeypatch.delenv(tuning.CACHE_ENV, raising=False)
    monkeypatch.setattr(dispatch, "_ENV_CACHES", {})
    dispatch.set_tuning_cache(TuningCache(path="/nonexistent"))
    yield
    dispatch.set_tuning_cache(None)


def _lora_args(m=64, k=32, n=48, r=4, dtype=BF16):
    g = torch.Generator().manual_seed(0)
    return tuple(torch.randn(s, generator=g).to(dtype)
                 for s in ((m, k), (k, n), (k, r), (r, n)))


def _filled(tmp_path, device=DEVICE, kernel="lora_matmul", key="k",
            config=None) -> TuningCache:
    cache = TuningCache(path=str(tmp_path / "tuning.json"))
    cache.store(device, kernel, autotune.source_hash(kernel), key,
                config or {"block_n": 128}, us=10.0, default_us=20.0)
    return cache


# ---------------------------------------------------------------------------
# the cache
# ---------------------------------------------------------------------------


def test_cache_json_round_trip(tmp_path):
    cache = _filled(tmp_path)
    path = cache.save()
    assert TuningCache.load(path).data == cache.data
    with open(path) as f:                         # plain JSON
        assert json.load(f) == cache.data


@pytest.mark.parametrize("text", [None, "{not json", "[1, 2]"])
def test_cache_missing_or_corrupt_loads_empty(tmp_path, text):
    path = tmp_path / "t.json"
    if text is not None:
        path.write_text(text)
    assert TuningCache.load(str(path)).data == {}


def test_cache_is_keyed_by_device_name(tmp_path):
    cache = _filled(tmp_path)
    h = autotune.source_hash("lora_matmul")
    assert cache.lookup(DEVICE, "lora_matmul", "k", h) == {"block_n": 128}
    assert cache.lookup("NVIDIA A100-SXM4-80GB", "lora_matmul", "k",
                        h) is None
    assert cache.lookup(DEVICE, "flash_decode", "k", h) is None
    assert cache.lookup(DEVICE, "lora_matmul", "other", h) is None


def test_stale_source_hash_drops_the_bucket(tmp_path):
    cache = _filled(tmp_path)
    assert cache.lookup(DEVICE, "lora_matmul", "k", "stale") is None
    cache.store(DEVICE, "lora_matmul", "new", "k2", {"block_n": 256}, 1.0,
                2.0)
    bucket = cache.data[DEVICE]["lora_matmul"]
    assert bucket["source_hash"] == "new"
    assert list(bucket["entries"]) == ["k2"]       # the old entry is gone


def test_source_hash_covers_the_cu_source_and_the_wrapper(monkeypatch):
    assert set(TUNABLES) == set(tuning.KERNELS)
    hashes = {name: autotune.source_hash(name) for name in TUNABLES}
    assert len(set(hashes.values())) == len(TUNABLES)
    assert autotune.source_hash("lora_matmul") == hashes["lora_matmul"]
    kernel = tuning.KERNELS["lora_matmul"]
    monkeypatch.setitem(tuning.KERNELS, "lora_matmul", tuning.TunedKernel(
        kernel.module, "flash_decode", kernel.key_kwargs))
    assert autotune.source_hash("lora_matmul") != hashes["lora_matmul"]
    monkeypatch.setitem(tuning.KERNELS, "lora_matmul", tuning.TunedKernel(
        "flash_decode", kernel.source, kernel.key_kwargs))
    assert autotune.source_hash("lora_matmul") != hashes["lora_matmul"]


def test_default_path_is_in_the_checkout_and_env_overrides(monkeypatch,
                                                          tmp_path):
    from repro_torch.kernels.build import BUILD_DIR
    monkeypatch.delenv(autotune.CACHE_ENV, raising=False)
    assert autotune.default_cache_path() == str(BUILD_DIR / "tuning.json")
    monkeypatch.setenv(autotune.CACHE_ENV, str(tmp_path / "x.json"))
    assert autotune.default_cache_path() == str(tmp_path / "x.json")
    assert TuningCache.load().path == str(tmp_path / "x.json")


def test_shape_key_reads_shapes_dtypes_and_the_plans_kwargs():
    a, b = torch.zeros(4, 8), torch.ones(4, 8)
    assert autotune.shape_key("lora_matmul", [a]) \
        == autotune.shape_key("lora_matmul", [b]) == "4x8:float32"
    assert autotune.shape_key("lora_matmul", [a.to(BF16)]) == "4x8:bfloat16"
    q = torch.zeros(1, 8, 2, 64)
    assert autotune.shape_key("flash_attention", [q], {"causal": False}) \
        != autotune.shape_key("flash_attention", [q], {"causal": True})


# ---------------------------------------------------------------------------
# plans, candidates, selection
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _cases():
    return list(autotune.path_cases("cpu"))


@pytest.mark.parametrize("case", range(8))
def test_candidates_are_default_first_and_each_plan_takes_them(case):
    name, tag, args, kwargs = _cases()[case]
    cands = autotune.candidate_configs(name, args, kwargs)
    assert cands[0] == DEFAULTS[name](args, kwargs)
    assert autotune.plan_for(name, args, kwargs) \
        == autotune.plan_for(name, args, kwargs, **cands[0])
    plans = [autotune.plan_for(name, args, kwargs, **c) for c in cands]
    assert len(set(plans)) == len(plans) >= 2, tag   # distinct, a real sweep
    # every combination left out is refused by the plan or repeats a plan
    knobs = TUNABLES[name]
    for values in itertools.product(*knobs.values()):
        cfg = dict(zip(knobs, values))
        try:
            p = autotune.plan_for(name, args, kwargs, **cfg)
        except ValueError:
            continue
        assert p in plans, (tag, cfg)


def test_candidates_follow_each_plans_refusals():
    name, _, args, kwargs = _cases()[3]             # llama attention
    assert autotune.candidate_configs(name, args, kwargs) == [
        {"block_q": 128, "block_kv": 128, "stages": 3},
        {"block_q": 64, "block_kv": 64, "stages": 2}]
    f32 = tuple(t.float() for t in args)            # one f32 tiling only
    assert autotune.candidate_configs(name, f32, kwargs) == [
        {"block_q": 32, "block_kv": 32, "stages": 1}]
    assert autotune.candidate_configs(
        "lora_matmul", _lora_args(dtype=torch.float32)) == [{"block_n": 64}]
    name, _, args, kwargs = _cases()[6]             # decode, C4096
    for cfg in autotune.candidate_configs(name, args, kwargs):
        assert cfg["chunk"] % fd.MMA_TILE == 0
        assert fd.MMA_MIN_STAGES <= cfg["stages"] <= fd.MMA_MAX_STAGES


def test_defaults_depend_on_the_shape():
    cases = _cases()
    assert DEFAULTS["lora_matmul"](cases[0][2]) == {"block_n": 256}
    assert DEFAULTS["lora_matmul"](cases[2][2]) == {"block_n": 128}
    assert DEFAULTS["flash_attention"](cases[4][2], cases[4][3]) == {
        "block_q": 128, "block_kv": 128, "stages": 4}
    assert DEFAULTS["flash_decode"](cases[6][2], cases[6][3]) \
        != DEFAULTS["flash_decode"](cases[7][2], cases[7][3])


@pytest.mark.parametrize("call", [
    lambda: autotune.plan_for("lora_matmul", _lora_args(), block_n=64),
    lambda: moe_ffn.plan(4, 128, 64, 32, BF16, block_n=512),
    lambda: moe_ffn.plan(4, 128, 64, 32, torch.float32, block_n=128),
    lambda: fa.plan(1, 64, 2, 2, 128, BF16, stages=2),
    lambda: fa.plan(1, 64, 2, 2, 128, BF16, variant="mma_sync",
                    block_q=128, block_kv=128, stages=3),
    lambda: fd.plan(2, 8, 2, 512, 128, 128, BF16, BF16, 132, chunk=96),
    lambda: fd.plan(2, 8, 2, 512, 128, 128, BF16, BF16, 132, stages=3),
    lambda: fd.plan(2, 8, 2, 512, 128, 128, torch.float32, BF16, 132,
                    stages=4),
])
def test_plans_refuse_what_their_kernel_does_not_take(call):
    with pytest.raises(ValueError):
        call()


def test_selection_is_default_first_with_strict_improvement():
    name, tag, args, kwargs = _cases()[6]
    cands = autotune.candidate_configs(name, args, kwargs)
    seen = []

    def flat(_name, cfg, _launch):
        seen.append(cfg)
        return 10.0                                 # all tie

    res = autotune.tune_case(name, tag, args, kwargs, measure=flat)
    assert seen[0] == cands[0] and seen == cands    # the default first
    assert res.is_default and res.us == res.default_us == 10.0
    assert res.n_candidates == len(cands)
    target = cands[-2]

    def biased(_name, cfg, _launch):
        return 5.0 if cfg == target else 10.0 + cands.index(cfg)

    res = autotune.tune_case(name, tag, args, kwargs, measure=biased)
    assert res.config == target and not res.is_default
    assert (res.us, res.default_us) == (5.0, 10.0)
    assert res.key == autotune.shape_key(name, args, kwargs)


def test_autotune_needs_a_card():
    with pytest.raises(RuntimeError, match="CUDA card"):
        autotune.autotune(["lora_matmul"])


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


def _fake_cuda(monkeypatch, calls, impl=None):
    """Resolve CPU tensors as if they lay on a Hopper card named DEVICE,
    with a recording stand-in for the lora_matmul kernel."""
    real = dispatch.resolve

    def resolve(backend, device):
        if str(device) == "cuda":
            return "reference" if dispatch.canonical(backend) == \
                "reference" else "pallas"
        return real(backend, device)

    def fake(*args, **kwargs):
        calls.append(kwargs)
        return None if impl is None else impl(*args, **kwargs)

    dispatch._ensure_builtin_kernels()
    monkeypatch.setattr(dispatch, "resolve", resolve)
    monkeypatch.setattr(dispatch, "device_name", lambda device: DEVICE)
    monkeypatch.setitem(dispatch._KERNELS["lora_matmul"], "pallas", fake)


def test_dispatch_passes_tuned_knobs_on_the_card_only(tmp_path,
                                                      monkeypatch):
    args = _lora_args()
    key = autotune.shape_key("lora_matmul", args)
    dispatch.set_tuning_cache(_filled(tmp_path, key=key,
                                      config={"block_n": 128}))
    calls = []
    _fake_cuda(monkeypatch, calls)
    assert dispatch.tuned_config("lora_matmul", args) == {"block_n": 128}
    dispatch.get_kernel("lora_matmul", "auto", "cuda")(*args, scaling=2.0)
    dispatch.get_kernel("lora_matmul", "pallas", "cuda")(*args, block_n=256)
    assert calls == [{"block_n": 128, "scaling": 2.0},
                     {"block_n": 256}]             # explicit knobs win
    dispatch.get_kernel("lora_matmul", "auto", "cuda", tuned=False)(*args)
    assert calls[-1] == {}
    # a miss passes nothing: the plan's own knobs
    dispatch.get_kernel("lora_matmul", "auto", "cuda")(*_lora_args(m=32))
    assert calls[-1] == {}


def test_dispatch_reads_a_cache_only_when_one_is_installed(tmp_path,
                                                         monkeypatch):
    args = _lora_args()
    key = autotune.shape_key("lora_matmul", args)
    calls = []
    _fake_cuda(monkeypatch, calls)
    fake = dispatch._KERNELS["lora_matmul"]["pallas"]
    # a filled cache at the default path is not read: nothing installed
    monkeypatch.setenv(tuning.CACHE_ENV, str(tmp_path / "tuning.json"))
    path = _filled(tmp_path, key=key, config={"block_n": 128}).save()
    assert tuning.default_cache_path() == path
    monkeypatch.delenv(tuning.CACHE_ENV)
    dispatch.set_tuning_cache(None)
    assert dispatch.tuning_cache() is None
    assert dispatch.get_kernel("lora_matmul", "auto", "cuda") is fake
    assert dispatch.tuned_config("lora_matmul", args) is None
    # the env var installs the file it names, read once
    monkeypatch.setenv(tuning.CACHE_ENV, path)
    dispatch.get_kernel("lora_matmul", "auto", "cuda")(*args)
    assert calls == [{"block_n": 128}]
    assert dispatch.tuning_cache() is dispatch.tuning_cache()
    # set_tuning_cache wins over the env var and hands back the last one
    empty = TuningCache(path=str(tmp_path / "none.json"))
    assert dispatch.set_tuning_cache(empty) is None
    dispatch.get_kernel("lora_matmul", "auto", "cuda")(*args)
    assert calls[-1] == {}
    assert dispatch.set_tuning_cache(None) is empty


def test_cpu_and_reference_resolution_never_read_the_cache(tmp_path,
                                                           monkeypatch):
    reads = []
    cache = _filled(tmp_path)
    monkeypatch.setattr(cache, "has_device",
                        lambda device: reads.append(device) or True)
    monkeypatch.setattr(cache, "lookup",
                        lambda *a: reads.append(a) or {"block_n": 128})
    dispatch.set_tuning_cache(cache)
    from repro_torch.kernels import ops, ref
    args = _lora_args(dtype=torch.float32)
    assert dispatch.get_kernel("lora_matmul", "auto", "cpu") \
        is ref.lora_matmul_ref
    out = ops.lora_matmul(*args, scaling=2.0)
    torch.testing.assert_close(out, ref.lora_matmul_ref(*args, scaling=2.0))
    calls = []
    _fake_cuda(monkeypatch, calls)
    assert dispatch.get_kernel("lora_matmul", "reference", "cuda") \
        is ref.lora_matmul_ref
    assert reads == []


def test_a_refused_cache_entry_raises(tmp_path, monkeypatch):
    args = _lora_args()
    key = autotune.shape_key("lora_matmul", args)
    dispatch.set_tuning_cache(_filled(tmp_path, key=key,
                                      config={"block_n": 64}))
    calls = []
    # the stand-in plans as the wrapper does, with the knobs it is given
    _fake_cuda(monkeypatch, calls, impl=lambda *a, scaling=1.0, **kn:
               autotune.plan_for("lora_matmul", a, **kn))
    with pytest.raises(ValueError, match="block_n"):
        dispatch.get_kernel("lora_matmul", "auto", "cuda")(*args)


def test_the_wrapper_keeps_the_counts_on_the_kernel(monkeypatch):
    from repro_torch.kernels.lora_matmul import lora_matmul_fused
    monkeypatch.setattr(dispatch, "resolve", lambda b, d: "pallas")
    wrapped = dispatch.get_kernel("lora_matmul", "auto", "cuda")
    assert wrapped.__wrapped__ is lora_matmul_fused
    assert not hasattr(wrapped, "launches")
    assert dispatch.get_kernel("ssd_scan", "auto", "cuda") \
        is dispatch._KERNELS["ssd_scan"]["pallas"]  # not tunable


# ---------------------------------------------------------------------------
# launch.env
# ---------------------------------------------------------------------------


def test_setup_environment_on_the_cpu(monkeypatch):
    try:
        first = setup_environment("cpu", cpu_cores=10**6)
        assert first == {"platform": "cpu", "cpu_cores": os.cpu_count()}
        assert torch.get_num_threads() == os.cpu_count()
        assert setup_environment("cpu", cpu_cores=10**6) == first
        assert setup_environment(cpu_cores=0)["cpu_cores"] == 1
        # the default dtype is the caller's unless x64 is asked for, and
        # the reference's JAX_ENABLE_X64 does not reach the port
        torch.set_default_dtype(torch.float64)
        assert setup_environment() == {}
        assert torch.get_default_dtype() == torch.float64
        torch.set_default_dtype(torch.float32)
        monkeypatch.setenv("JAX_ENABLE_X64", "1")
        assert setup_environment() == {}
        assert torch.get_default_dtype() == torch.float32
        assert setup_environment(x64=True) == {"x64": True}
        assert torch.get_default_dtype() == torch.float64
    finally:
        torch.set_default_dtype(torch.float32)
        torch.set_num_threads(1)


@pytest.mark.parametrize("platform", ["gpu", "cuda"])
def test_setup_environment_gpu_raises_without_a_card(platform):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        setup_environment(platform)


def test_setup_environment_rejects_an_unknown_platform():
    with pytest.raises(ValueError, match="tpu"):
        setup_environment("tpu")
