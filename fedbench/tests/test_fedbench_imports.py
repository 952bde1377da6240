"""No module of the JAX package, nor JAX itself, loads in the benchmark's
process, and the reference loads nothing of the port: by the top-level
name, compared whole (``repro_torch`` begins with ``repro``)."""
from __future__ import annotations

import ast
import subprocess
import sys
import textwrap
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imported_tops(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_file_imports_jax_or_the_jax_package():
    for path in HERE.rglob("*.py"):
        assert not set(_imported_tops(path)) & FORBIDDEN, path


def test_reference_files_import_nothing_of_the_port():
    for path in (HERE / "reference").rglob("*.py"):
        assert "repro_torch" not in set(_imported_tops(path)), path


def _tops_after(code: str):
    out = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(code) + textwrap.dedent("""
            import sys
            print(sorted({m.split(".")[0] for m in sys.modules}))
        """)], capture_output=True, text=True, cwd=ROOT,
        env={"PYTHONPATH": f"{ROOT}:{ROOT / 'src'}", "PATH": "/usr/bin:/bin",
             "OMP_NUM_THREADS": "1"}, timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_a_reduced_run_loads_no_jax():
    tops = _tops_after("""
        import json, sys, tempfile
        from pathlib import Path
        sys.path[:0] = ["fedbench/tests"]
        import torch
        torch.set_num_threads(1)
        import fedbench.run
        from conftest import toy_copy
        from fedbench.bench import Bench
        d = Path(tempfile.mkdtemp())
        bj = toy_copy(d / "fb")
        bench = Bench(here=d / "fb", bench_json=bj)
        doc = bench.workload("granite-moe-1b.devft")
        tr = bench.traffic(doc["traffic"])
        fed = bench.runner(tr)
        cfg = bench.config(doc["config"])
        cell = fed.Cell(cfg, bench.reference(cfg), tr, 1, "cpu", {})
        cell.job()
        import fedbench.reference.fed
    """)
    assert not tops & FORBIDDEN, tops & FORBIDDEN
    assert "repro_torch" in tops


def test_the_reference_loads_nothing_of_the_port():
    tops = _tops_after("""
        import fedbench.reference.fed, fedbench.reference.model
        import fedbench.reference.devft, fedbench.check, fedbench.data
    """)
    assert not tops & (FORBIDDEN | {"repro_torch"})
