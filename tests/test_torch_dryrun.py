"""The one-card dry-run (``repro_torch.launch.dryrun``) on the CPU.

* ``model_flops`` equals the JAX package's exactly for every arch at
  every input shape. The JAX numbers come from one subprocess:
  ``repro.launch.dryrun`` sets ``XLA_FLAGS`` to 512 host devices when it
  is imported, so it never enters a pytest worker.
* ``calibrate``'s corrected FLOPs equal the full-depth count (the port
  runs layers in a loop: nothing is folded as a scan body is).
* Every hand kernel is a stand-in counted from its shapes, one per
  launch the card would make, and ``dispatch`` resolves meta tensors to
  the stand-ins only while the dry-run counts.
* The CLI runs here, on meta tensors, and writes its JSON without
  allocating the model, with the multi-device options too.
"""
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import (ALL_ARCH_IDS, INPUT_SHAPES, InputShape,
                                 ReducedSpec, get_config, get_shape,
                                 reduce_config)
from repro_torch.kernels import dispatch, ref
from repro_torch.launch import dryrun as D

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the param specs of one arch are the same at every shape: build them
# once per arch (the JAX function runs unchanged on them)
_JAX_MODEL_FLOPS = """
import functools, json
from repro.configs import ALL_ARCH_IDS, INPUT_SHAPES, get_config
from repro.launch import specs
specs.param_specs = functools.lru_cache(maxsize=None)(specs.param_specs)
from repro.launch.dryrun import model_flops
print(json.dumps({a: {s: model_flops(get_config(a), sh)
                      for s, sh in INPUT_SHAPES.items()}
                  for a in ALL_ARCH_IDS}))
"""


def _env():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return env


@pytest.fixture(scope="module")
def jax_model_flops():
    out = subprocess.run([sys.executable, "-c", _JAX_MODEL_FLOPS],
                         capture_output=True, text=True, check=True,
                         env=_env(), cwd=ROOT, timeout=300)
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("shape", list(INPUT_SHAPES))
@pytest.mark.parametrize("arch", ALL_ARCH_IDS)
def test_model_flops_equal_jax(arch, shape, jax_model_flops):
    got = D.model_flops(get_config(arch), get_shape(shape))
    assert got == jax_model_flops[arch][shape]


SMALL = ReducedSpec(n_layers=4, d_model=128, n_heads=4, n_kv_heads=2,
                    d_ff=256, vocab=256, n_experts=4, top_k=2)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["llama2-7b-proxy", "granite-moe-1b-a400m",
                                  "mamba2-2.7b", "deepseek-v3-671b",
                                  "whisper-tiny"])
def test_calibration_equals_full_depth_flops(arch, kind):
    cfg = reduce_config(get_config(arch), SMALL)
    shape = InputShape("small", 32, 2, kind)
    fn, args = D.build_cfg(cfg, shape)
    full = D.measure(fn, args)
    cal = D.calibrate(cfg, shape)
    assert cal["corrected_flops_per_device"] == full["flops"]
    assert set(cal["per_layer"]) == {s for s, _ in cfg.layer_stacks()}


def test_calibration_skips_the_hybrid_order():
    cfg = reduce_config(get_config("jamba-v0.1-52b"), SMALL)
    assert D.calibrate(cfg, InputShape("small", 32, 2, "train")) is None


def test_card_path_counts_each_kernel_launch_from_its_shapes():
    cfg = reduce_config(get_config("llama2-7b-proxy"), SMALL)
    shape = InputShape("small", 64, 2, "train")
    n = cfg.n_layers
    for remat, again in ((False, 1), (True, 2)):
        fn, args = D.build_cfg(cfg, shape, remat=remat)
        card = D.measure(fn, args)
        assert card["kernel_calls"] == {"lora_matmul": 2 * n * again,
                                        "flash_attention": n * again}
    # the stand-ins are dispatch's resolution of meta tensors only while
    # the dry-run counts: outside it meta gets the plain versions again
    assert not dispatch.use_kernel("auto", "meta")
    assert dispatch.get_kernel("lora_matmul", "auto", "meta") \
        is ref.lora_matmul_ref
    with dispatch.meta_kernels({"lora_matmul": len}):
        assert dispatch.use_kernel("pallas", "meta")
        assert not dispatch.use_kernel("reference", "meta")
        assert not dispatch.use_kernel("auto", "cpu")
        assert dispatch.get_kernel("lora_matmul", "auto", "meta") is len
        with pytest.raises(RuntimeError, match="already active"):
            with dispatch.meta_kernels({}):
                pass
    assert not dispatch.use_kernel("auto", "meta")


@pytest.mark.parametrize("s,causal,window", [
    (64, True, None), (64, False, None), (64, True, 16), (64, False, 16),
    (17, True, 32), (50, True, 7)])
def test_live_pairs_match_the_mask(s, causal, window):
    i, j = np.arange(s)[:, None], np.arange(s)[None, :]
    keep = np.ones((s, s), bool)
    if causal:
        keep &= j <= i
    if window is not None:
        keep &= j > i - window
    assert D._live_pairs(s, causal, window) == int(keep.sum())


# ``python -m repro_torch.launch.dryrun ARGS``, then the process's own
# peak RSS (KiB) on the last line
_CLI = """
import resource, runpy, sys
sys.argv = ["dryrun"] + sys.argv[1:]
try:
    runpy.run_module("repro_torch.launch.dryrun", run_name="__main__")
except SystemExit as e:
    assert not e.code, e.code
print(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss)
"""


def test_cli_runs_llama_train_4k_on_meta(tmp_path):
    """The acceptance command, in a child process whose peak RSS stays
    far below the 13.7 GB of arguments it reports."""
    out = subprocess.run(
        [sys.executable, "-c", _CLI, "--arch", "llama2-7b-proxy", "--shape",
         "train_4k", "--out-dir", str(tmp_path)], check=True, env=_env(),
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    res = json.loads((tmp_path / "llama2-7b-proxy_train_4k.json")
                     .read_text())
    mem = res["memory_analysis"]
    assert mem["argument_size_in_bytes"] > 13e9
    assert int(out.stdout.split()[-1]) < 4 * 2**20    # KiB: under 4 GiB
    for key in ("model_flops", "useful_ratio", "calibration", "t_compute",
                "t_memory", "bottleneck", "flops_per_device",
                "bytes_per_device", "fits", "device"):
        assert key in res, key
    assert set(mem) == {"argument_size_in_bytes", "output_size_in_bytes",
                        "temp_size_in_bytes"}
    assert res["chips"] == 1 and res["shape_counted_ops"] == {
        "lora_matmul": 128, "flash_attention": 64}
    assert res["calibration"]["corrected_flops_per_device"] \
        == res["flops_per_device"]
    assert res["fits"] == (mem["argument_size_in_bytes"]
                           + mem["temp_size_in_bytes"] <= 80e9)


def test_cli_runs_an_moe_arch(tmp_path, capsys):
    assert D.main(["--arch", "granite-moe-1b-a400m", "--shape",
                   "prefill_32k", "--remat", "dots_with_no_batch_dims_"
                   "saveable", "--out-dir", str(tmp_path)]) == 0
    res = json.loads((tmp_path / "granite-moe-1b-a400m_prefill_32k.json")
                     .read_text())
    assert res["shape_counted_ops"]["moe_expert_ffn"] == 24
    assert res["model_flops"] == D.model_flops(
        get_config("granite-moe-1b-a400m"), get_shape("prefill_32k"))
    assert '"bottleneck"' in capsys.readouterr().out


@pytest.fixture
def no_group_left():
    """``--moe-path ep|gather_sharded`` starts a world-1 group in this
    process (``make_host_mesh``): destroy it, so no group outlives the
    test in the worker."""
    yield
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


@pytest.mark.parametrize("argv", [["--multi-pod"],
                                  ["--moe-path", "ep"],
                                  ["--moe-path", "gather_sharded"]])
def test_multi_device_options_raise(argv, tmp_path, no_group_left):
    """The multi-device options, which raised until the port had meshes,
    now run and report: ``--multi-pod`` adds each input tree's bytes per
    device on the 2x16x16 mesh and counts the rest as one card;
    ``--moe-path`` runs on a 1x1 mesh, ``gather_sharded`` counting what
    ``gather`` counts and ``ep`` its local capacity's expert FLOPs."""
    arch, shape = "granite-moe-1b-a400m", "decode_32k"
    assert D.main(["--arch", arch, "--shape", shape, "--out-dir",
                   str(tmp_path)] + argv) == 0
    suffix = "_mp" if argv == ["--multi-pod"] else f"_{argv[1]}"
    res = json.loads((tmp_path / f"{arch}_{shape}{suffix}.json").read_text())
    plain = D.run_one(arch, shape)
    assert res["shape_counted_ops"] == plain["shape_counted_ops"] == {
        "flash_decode": 24, "moe_expert_ffn": 24}
    assert res["memory_analysis"] == plain["memory_analysis"]
    if argv == ["--multi-pod"]:
        per = res["per_device_argument_bytes"]
        assert sorted(per) == ["batch", "cache", "lora", "params"]
        assert 0 < sum(per.values()) < \
            plain["memory_analysis"]["argument_size_in_bytes"]
        assert res["mesh"] is None
    else:
        assert res["mesh"] == "1x1" and res["moe_path"] == argv[1]
        assert "per_device_argument_bytes" not in res
    if argv[-1] == "ep":
        cfg, t = get_config(arch), get_shape(shape).global_batch
        m = cfg.moe
        cap = max(8, -(-math.ceil(t * m.top_k / m.n_experts
                                  * m.capacity_factor) // 8) * 8)
        cap_l = max(8, -(-t * m.top_k // m.n_experts) * 2)
        assert cap_l != cap
        assert res["flops_per_device"] - plain["flops_per_device"] == 24 * (
            6 * m.n_experts * (cap_l - cap) * cfg.d_model * m.d_ff_expert)
    else:
        for key in ("flops_per_device", "bytes_per_device", "flops_by_dtype",
                    "calibration"):
            assert res[key] == plain[key], key
