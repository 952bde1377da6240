"""The PyTorch port's training entry point against a live run of the JAX
package: ``ExperimentSpec`` -> ``run_experiment`` -> ``FederatedRunner``
(DevFT and FedIT strategies) -> ``RunResult``, and the CLI.

Both sides start from the JAX package's pretrained base
(``pretrained_base``: homogeneous init, 60 pretraining steps) and its
initial LoRA, crossed through numpy; data, cohorts and round plans are
numpy in both. Compared per ``RoundLog``:

* integer fields exactly: round, stage, capacity, comm bytes up/down,
  memory_bytes, n_dropped;
* eval_loss, eval_acc, flops and sim_time_s at rel = abs = 1e-3, the
  limits the JAX package holds its own two backends to
  (``tests/test_kernel_dispatch.py:330``);
* the final LoRA at the same limits on at least 99% of each leaf's
  elements, and every element within 2·lr·(local steps a client ran):
  Adam moves an element by about lr whatever the size of its gradient,
  so an element whose gradient is within rounding of zero may step
  either way (measured: 10 of 4096 elements of one leaf, 0.24%, after
  six bench-tiny rounds at lr 1e-2), the argument and the limits of
  ``tests/test_torch_federated.py``.

DevFT's group lists decide the capacities and the fused submodels, so a
trajectory that agrees also shows the group lists and transfer maps
agree (``tests/test_torch_devft_core.py`` checks them one by one).
Never compared with ``tests/golden/`` (ROADMAP.md, "Faults").

The granite-moe-1b-a400m runs and the ``hetero-edge`` plans are in
``tests/test_torch_runner_moe.py``.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.experiments import get_preset as jax_get_preset
from repro.experiments import run_experiment as jax_run_experiment
from repro.experiments.runner import pretrained_base as jax_pretrained_base
from repro.launch import train as jax_train
from repro.models import transformer as JT
from repro_torch import interop
from repro_torch.experiments import ExperimentSpec, RunResult, get_preset
from repro_torch.experiments import run_experiment
from repro_torch.federated import FedConfig, FederatedRunner, RoundLog

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
INT_FIELDS = ("round", "stage", "capacity", "comm_bytes_up",
              "comm_bytes_down", "memory_bytes", "n_dropped")
FLOAT_FIELDS = ("eval_loss", "eval_acc", "flops", "sim_time_s")


def run_both(spec_kw, preset="bench-tiny"):
    """(port RunResult, JAX RunResult) of one spec, from the JAX
    package's base params and initial LoRA."""
    return run_pair(jax_get_preset(preset).replace(**spec_kw),
                    get_preset(preset).replace(**spec_kw))


def run_pair(jspec, pspec):
    """(port RunResult, JAX RunResult) of one spec given to each package,
    from the JAX package's base params and initial LoRA."""
    assert pspec.spec_hash() == jspec.spec_hash()
    want = jax_run_experiment(jspec)
    if jspec.pretrain_steps:
        params, _ = jax_pretrained_base(jspec)
    else:
        # the JAX round engine's own init: f32 params (FederatedRunner's
        # dtype), whatever the config's dtype
        params = JT.init_params(jspec.build_cfg(),
                                jax.random.PRNGKey(jspec.seed), jnp.float32)
    lora = JT.init_lora(jspec.build_cfg(),
                        jax.random.fold_in(jax.random.PRNGKey(jspec.seed), 1),
                        rank=jspec.lora_rank)
    to_port = lambda t: interop.from_numpy_tree(  # noqa: E731
        jax.tree.map(np.asarray, t))
    got = run_experiment(pspec, params=to_port(params), lora=to_port(lora),
                         device="cpu")
    return got, want


def check_trajectory(got, want):
    assert len(got.logs) == len(want.logs)
    for g, w in zip(got.logs, want.logs):
        g, w = dataclasses.asdict(g), dataclasses.asdict(w)
        for f in INT_FIELDS:
            assert g[f] == w[f], (f, g, w)
        for f in FLOAT_FIELDS:
            assert g[f] == pytest.approx(w[f], rel=1e-3, abs=1e-3), (f, g, w)
    gl, wl = interop.tree_paths(got.final_lora), \
        jax.tree_util.tree_flatten_with_path(want.final_lora)[0]
    assert [p for p, _ in gl] == [tuple(k.key for k in p) for p, _ in wl]
    spec = got.spec
    steps = spec.rounds * spec.k_local
    for (path, g), (_, w) in zip(gl, wl):
        g, w = g.numpy(), np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=0, atol=2 * spec.lr * steps)
        off = ~np.isclose(g, w, rtol=1e-3, atol=1e-3)
        assert off.mean() <= 0.01, (path, off.mean())


@pytest.mark.parametrize("method", ["devft", "fedit"])
def test_bench_tiny_llama_trajectory_matches_jax(method):
    got, want = run_both({"method": method})
    check_trajectory(got, want)
    caps = [log.capacity for log in got.logs]
    assert caps == ([2, 2, 2, 4, 4, 4] if method == "devft" else [4] * 6)
    assert got.metrics["comm_MB"] == want.metrics["comm_MB"]


def test_bench_tiny_devft_variants_match_jax():
    """The ablation knobs through the engine: random grouping, R-ONE
    fusion, three stages from an initial capacity, eval every other
    round (skipped rounds carry the last eval forward)."""
    got, want = run_both({"method": "devft", "grouping": "random",
                          "fusion": "rone", "initial_capacity": 1,
                          "n_stages": 3, "eval_every": 2})
    check_trajectory(got, want)
    assert [log.capacity for log in got.logs] == [1, 1, 2, 2, 4, 4]
    losses = [log.eval_loss for log in got.logs]
    assert losses[1] == losses[0] and losses[3] == losses[2]


def test_runner_checks_its_inputs():
    spec = get_preset("bench-tiny")
    cfg = spec.build_cfg()
    from repro_torch.data.synthetic import make_federated_data
    data = make_federated_data(cfg.vocab, n_clients=8, seed=0)
    fed = spec.fed_config()
    with pytest.raises(TypeError, match="DeviceMesh"):
        FederatedRunner(cfg, fed, data, mesh="host", device="cpu")
    for bad in (dict(straggler_policy="never"), dict(weighting="median"),
                dict(deadline_factor=0.0), dict(method="fedprox")):
        with pytest.raises(ValueError):
            FederatedRunner(cfg, dataclasses.replace(fed, **bad), data,
                            device="cpu")
    tiny = spec.replace(rounds=1, pretrain_steps=0, layers=1, n_clients=2,
                        sample_frac=0.5, k_local=1, local_batch=1, seq=8)
    # mesh="host" runs on a 1x1 mesh (a world-1 group, destroyed here:
    # none may outlive the test in the worker) and gives mesh=None's bits
    try:
        on_mesh = run_experiment(tiny.replace(mesh="host"), device="cpu")
    finally:
        torch.distributed.destroy_process_group()
    plain = run_experiment(tiny, device="cpu")
    assert [dataclasses.asdict(log) for log in on_mesh.logs] \
        == [dataclasses.asdict(log) for log in plain.logs]
    for a, b in zip(interop.tree_leaves(on_mesh.final_lora),
                    interop.tree_leaves(plain.final_lora)):
        assert torch.equal(a, b)
    exported = run_experiment(tiny, export_adapters=True, device="cpu")
    assert sorted(exported.adapter_registry.ids()) \
        == ["client/0", "client/1", "global"]
    # FedConfig mirrors the JAX package's field for field, defaults too
    from repro.federated import FedConfig as JaxFedConfig
    assert dataclasses.asdict(FedConfig()) \
        == dataclasses.asdict(JaxFedConfig())
    # the result artifact round-trips
    res = RunResult(spec=spec, logs=[RoundLog(0, 0, 2, 1.0, 0.5, 1, 2, 3.0,
                                              4)], wall_s=0.1, metrics={})
    assert RunResult.from_dict(json.loads(json.dumps(res.to_dict()))) \
        .logs == res.logs


def test_jax_dump_spec_loads_with_the_same_hash(capsys):
    argv = ["--dump-spec", "--preset", "bench-tiny", "--arch",
            "granite-moe-1b-a400m", "--method", "devft", "--rounds", "4",
            "--n-stages", "4", "--kernel-backend", "reference",
            "--flora-ranks", "8,4", "--population", "tiered-3"]
    assert jax_train.main(argv) == 0
    text = capsys.readouterr().out
    spec = ExperimentSpec.from_json(text)
    jspec = jax_train.spec_from_args(jax_train.build_parser().parse_args(
        argv))
    assert spec.spec_hash() == jspec.spec_hash()
    assert spec.base_key() == jspec.base_key()
    assert spec.to_json() == jspec.to_json()
    from repro_torch.launch import train as ptrain
    assert ptrain.main(argv) == 0
    assert capsys.readouterr().out == text


def test_cli_runs_on_the_cpu(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO / "src")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--preset", "bench-tiny", "--rounds", "2", "--out", str(tmp_path)],
        capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    lines = out.stdout.splitlines()
    rounds = [line for line in lines if line.startswith("round ")]
    assert len(rounds) == 2 and "stage 1 cap   4" in rounds[1]
    assert lines[-1].startswith("done in ")
    tag = "llama2-7b-proxy_devft_s0"
    res = RunResult.load(str(tmp_path / f"{tag}.result.json"))
    assert [log.round for log in res.logs] == [0, 1]
    assert res.spec == get_preset("bench-tiny").replace(rounds=2)
    assert json.loads((tmp_path / f"{tag}.json").read_text())[1]["capacity"] \
        == 4
    # the final LoRA in the JAX package's checkpoint format
    from repro.checkpoint import restore as jax_restore
    template = {"lora": JT.init_lora(res.spec.build_cfg(),
                                     jax.random.PRNGKey(0),
                                     rank=res.spec.lora_rank)}
    lora = jax_restore(str(tmp_path / f"{tag}.ckpt"), template)
    assert all(bool(jnp.isfinite(leaf).all())
               for leaf in jax.tree.leaves(lora))
