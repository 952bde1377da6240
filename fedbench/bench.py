"""The benchmark's data, found by name: ``BENCHMARK.json`` at the root of
the checkout, a configuration in ``configs/<name>.json`` naming its plain
reference ``reference/<module>.py`` (``fedbench.reference``), a traffic
mix in ``traffic/<name>.json`` naming its runner (``runners/<runner>.py``),
a per-layer metric's reader in ``metrics/<name>.py`` (or a family reader,
see ``fedbench.metrics``), a kernel's counts in ``kernels/<registry
name>.py`` and a cell's limits in ``limits/<workload>.json``."""
from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_module(path: Path, name: str) -> ModuleType:
    """The module at ``path``, loaded once a process under ``name``."""
    mod = sys.modules.get(name)
    if mod is not None and Path(mod.__file__) == Path(path):
        return mod
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


class Bench:
    """The benchmark rooted at ``here`` (this folder by default), with
    ``BENCHMARK.json`` at ``bench_json``."""

    def __init__(self, here: Path = HERE, bench_json: Optional[Path] = None):
        self.here = Path(here)
        self.bench_json = Path(bench_json or ROOT / "BENCHMARK.json")
        self.doc = json.loads(self.bench_json.read_text())

    def workload(self, name: str) -> dict:
        for w in self.doc["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                       f"{[w['name'] for w in self.doc['workloads']]}")

    def config(self, name: str) -> dict:
        return json.loads((self.here / "configs" / f"{name}.json").read_text())

    def reference(self, cfg_doc: dict) -> ModuleType:
        """The reference module the configuration ``cfg_doc`` names."""
        from fedbench.reference import module_for

        return module_for(cfg_doc, self.here)

    def traffic(self, name: str) -> dict:
        return json.loads((self.here / "traffic" / f"{name}.json").read_text())

    def runner(self, traffic: dict) -> ModuleType:
        name = traffic["runner"]
        return load_module(self.here / "runners" / f"{name}.py",
                           f"fedbench_runner_{name}")

    def kernel_files(self) -> Dict[str, ModuleType]:
        return {p.stem: load_module(p, f"fedbench_kernel_{p.stem}")
                for p in sorted((self.here / "kernels").glob("*.py"))
                if not p.stem.startswith("_")}

    def metrics_for(self, workload: str, kind: str):
        """The ``end_to_end`` or ``per_layer`` entries this cell reports."""
        return [m for m in self.doc[kind]
                if "workloads" not in m or workload in m["workloads"]]

    def reader(self, metric: str):
        """``read(ctx)`` for ``metric``: its own file, else the family
        reader named by the part after the last ``_``."""
        path = self.here / "metrics" / f"{metric}.py"
        if path.exists():
            return load_module(path, f"fedbench_metric_{metric}").read
        head, _, family = metric.rpartition("_")
        path = self.here / "metrics" / f"{family}.py"
        if head and path.exists():
            fn = load_module(path, f"fedbench_metric_{family}").read
            return lambda ctx: fn(ctx, head)
        raise FileNotFoundError(f"no reader for metric {metric!r} in "
                                f"{self.here / 'metrics'}")

    def peaks(self) -> dict:
        return json.loads((self.here / "peaks.json").read_text())
