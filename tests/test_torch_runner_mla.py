"""The PyTorch port's DevFT on MLA (reduced deepseek-v3-671b: a dense
``mla_mlp`` prefix and an ``mla_moe`` stack with the shared expert)
through the round engine, against a live run of the JAX package (the
helpers and limits of ``tests/test_torch_runner.py``: integer
``RoundLog`` fields exactly, float fields at rel = abs = 1e-3, the final
LoRA leaf by leaf).

The spec is ``bench-tiny`` at ``layers=3`` (1 dense + 2 MoE layers, the
reduced config's own depth), DevFT in 2 stages of three rounds: stage 0
trains the submodel of one dense and one MoE layer (capacity 2, the MoE
stack fused by DGLG and DBLF), stage 1 the whole model (capacity 3).
The chained run is held whole: unlike the Mamba-2 paths
(``tests/test_torch_runner_hybrid.py``) it stays within the limits over
all six rounds. The CLI test resolves the same arch through both
packages' parsers. Never compared with ``tests/golden/``.
"""
import os
import subprocess
import sys

from repro.experiments import get_preset as jax_get_preset
from repro.launch import train as jax_train
from repro_torch.experiments import get_preset
from repro_torch.launch import train as ptrain
from test_torch_runner import REPO, check_trajectory, run_pair

ARGV = ["--arch", "deepseek-v3-671b", "--method", "devft", "--rounds", "2",
        "--n-stages", "2", "--n-clients", "4", "--sample-frac", "0.5",
        "--k-local", "1", "--local-batch", "2", "--seq", "16",
        "--lora-rank", "2"]


def test_bench_tiny_devft_on_deepseek_matches_jax():
    kw = {"arch": "deepseek-v3-671b", "method": "devft", "layers": 3}
    got, want = run_pair(jax_get_preset("bench-tiny").replace(**kw),
                         get_preset("bench-tiny").replace(**kw))
    check_trajectory(got, want)
    assert [log.capacity for log in got.logs] == [2, 2, 2, 3, 3, 3]
    assert got.metrics["comm_MB"] == want.metrics["comm_MB"]
    assert {name: sorted(t) for name, t in got.final_lora.items()} == {
        "dense": ["wkv_b", "wq_b"], "moe": ["wkv_b", "wq_b"]}


def test_cli_spec_and_run_on_deepseek(tmp_path):
    jspec = jax_train.spec_from_args(jax_train.build_parser().parse_args(
        ARGV))
    pspec = ptrain.spec_from_args(ptrain.build_parser().parse_args(ARGV))
    assert pspec.spec_hash() == jspec.spec_hash()
    assert pspec.build_cfg().attn_kind == "mla"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO / "src")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *ARGV,
         "--device", "cpu", "--out", str(tmp_path)],
        capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    rounds = [line for line in out.stdout.splitlines()
              if line.startswith("round ")]
    assert len(rounds) == 2 and "stage 1 cap   3" in rounds[1]
    assert (tmp_path / "deepseek-v3-671b_devft_s0.result.json").exists()


def test_serve_cli_runs_deepseek_on_the_cpu():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO / "src")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--arch", "deepseek-v3-671b", "--batch", "2", "--requests", "3",
         "--prompt-len", "4", "--gen", "3", "--n-adapters", "2"],
        capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "arch=deepseek-v3-671b device=cpu slots=2 requests=3" in out.stdout
