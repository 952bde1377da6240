"""The PyTorch port's DevFT training entry point on Mamba-2, against a
live run of the JAX package (the helpers and limits of
``tests/test_torch_runner.py``: integer ``RoundLog`` fields exactly,
float fields at rel = abs = 1e-3, the final LoRA leaf by leaf).

Both specs come from each package's own CLI parser with the same
arguments: reduced mamba2-2.7b (4 layers of ``mamba_only`` blocks),
DevFT in 2 stages of one round each (capacities 2 -> 4), 2 of 4 clients
x 1 local step of 2 x 16 tokens, rank-2 LoRA on in_proj and out_proj.
Never compared with ``tests/golden/``.
"""
import os
import subprocess
import sys

from repro.launch import train as jax_train
from repro_torch.launch import train as ptrain
from test_torch_runner import REPO, check_trajectory, run_pair

ARGV = ["--arch", "mamba2-2.7b", "--method", "devft", "--rounds", "2",
        "--n-stages", "2", "--n-clients", "4", "--sample-frac", "0.5",
        "--k-local", "1", "--local-batch", "2", "--seq", "16",
        "--lora-rank", "2", "--layers", "4"]


def test_devft_on_mamba2_matches_jax():
    jspec = jax_train.spec_from_args(jax_train.build_parser().parse_args(
        ARGV))
    pspec = ptrain.spec_from_args(ptrain.build_parser().parse_args(ARGV))
    assert pspec.build_cfg().family == "ssm"
    got, want = run_pair(jspec, pspec)
    check_trajectory(got, want)
    assert [log.capacity for log in got.logs] == [2, 4]
    assert got.metrics["comm_MB"] == want.metrics["comm_MB"]
    assert set(got.final_lora["layers"]) == {"in_proj", "out_proj"}


def test_cli_runs_mamba2_on_the_cpu_only_when_asked(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO / "src")
    cmd = [sys.executable, "-m", "repro_torch.launch.train", *ARGV,
           "--out", str(tmp_path)]
    out = subprocess.run(cmd + ["--device", "cpu"], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    rounds = [line for line in out.stdout.splitlines()
              if line.startswith("round ")]
    assert len(rounds) == 2 and "stage 1 cap   4" in rounds[1]
    assert (tmp_path / "mamba2-2.7b_devft_s0.result.json").exists()
    # the default device is the card: without one the CLI refuses
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run(cmd, capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode != 0
    assert "cuda" in (out.stdout + out.stderr).lower()
