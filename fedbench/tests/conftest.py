"""Shared pieces of the benchmark's CPU tests: the repo root and ``src`` on
the path, one thread, a copy of the benchmark's data at toy sizes, and a
run of ``fedbench/run.py`` on the CPU in a process of its own."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

import torch  # noqa: E402

torch.set_num_threads(1)

#: the configurations' widths and the traffic's sizes cut to toy ones
TOY_MODEL = {
    "granite-moe-1b-a400m": {"n_layers": 4, "d_model": 64, "n_heads": 4,
                             "n_kv_heads": 2, "head_dim": 16, "d_ff": 32,
                             "vocab": 256},
    "jamba-v0.1-8l": {"d_model": 64, "n_heads": 4, "n_kv_heads": 2,
                      "head_dim": 16, "d_ff": 64, "vocab": 256},
}
TOY_MOE = {"n_experts": 4, "top_k": 2, "d_ff_expert": 32}
TOY_MAMBA = {"d_state": 8, "head_dim": 16, "chunk": 8}
TOY_SPEC = {"k_local": 3, "local_batch": 2, "seq": 16}


def toy_copy(dst: Path, dtype: str = "float32", bench_json=None) -> Path:
    """The benchmark's folder copied to ``dst`` with toy configurations and
    traffic; returns the BENCHMARK.json written beside it."""
    shutil.copytree(HERE, dst, ignore=shutil.ignore_patterns(
        "tests", "__pycache__"))
    for name, kw in TOY_MODEL.items():
        p = dst / "configs" / f"{name}.json"
        doc = json.loads(p.read_text())
        doc["model"].update(kw, dtype=dtype)
        doc["model"]["moe"].update(TOY_MOE)
        if "mamba" in doc["model"]:
            doc["model"]["mamba"].update(TOY_MAMBA)
        doc["lora"]["rank"] = 4
        p.write_text(json.dumps(doc))
    for p in (dst / "traffic").glob("*.json"):
        doc = json.loads(p.read_text())
        doc["spec"].update(TOY_SPEC)
        p.write_text(json.dumps(doc))
    out = dst.parent / "BENCHMARK.json"
    out.write_text(json.dumps(bench_json or json.loads(
        (ROOT / "BENCHMARK.json").read_text())))
    return out


@pytest.fixture
def toy_bench(tmp_path):
    """A ``Bench`` over the toy copy (f32, so the program and the
    reference agree to rounding)."""
    from fedbench.bench import Bench

    bj = toy_copy(tmp_path / "fb")
    return Bench(here=tmp_path / "fb", bench_json=bj)


def run_cpu(bench, argv, fault=None):
    """(exit code, standard output lines, standard error lines) of
    ``fedbench/run.py`` with ``argv`` over ``bench``'s folder and
    BENCHMARK.json on the CPU, in a fresh process that never imported JAX
    (``run_cpu.py``); ``fault`` plants a fault in the program."""
    cmd = [sys.executable, str(HERE / "tests" / "run_cpu.py"),
           "--here", str(bench.here), "--bench-json", str(bench.bench_json)]
    if fault:
        cmd += ["--fault", fault]
    env = dict(os.environ, PYTHONPATH=f"{ROOT}{os.pathsep}{ROOT / 'src'}",
               OMP_NUM_THREADS="1")
    out = subprocess.run(cmd + ["--", *argv], capture_output=True, text=True,
                         cwd=ROOT, env=env, timeout=600)
    return (out.returncode, out.stdout.splitlines(),
            out.stderr.splitlines())
