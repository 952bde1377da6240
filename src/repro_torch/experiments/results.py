"""RunResult — the structured outcome of one experiment (the JAX
package's ``repro.experiments.results``; the same JSON artifact).

Carries the spec that produced it, the per-round logs, wall time, and
the standardized summary metrics; saves/loads as a versioned JSON
artifact (schema-tagged, spec embedded, so an artifact is always
re-runnable).
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Optional

from repro_torch.experiments.spec import SCHEMA_VERSION, ExperimentSpec
from repro_torch.federated.simulator import RoundLog


def summarize(logs, wall_s: float) -> Dict[str, Any]:
    """Standardized end-of-run metrics (shared by CLI + benchmarks)."""
    total_up = sum(l.comm_bytes_up for l in logs)
    total_down = sum(l.comm_bytes_down for l in logs)
    total_flops = sum(l.flops for l in logs)
    return {
        "final_loss": round(logs[-1].eval_loss, 4),
        "final_acc": round(logs[-1].eval_acc, 4),
        "best_loss": round(min(l.eval_loss for l in logs), 4),
        "comm_MB": round((total_up + total_down) / 1e6, 3),
        "uplink_MB": round(total_up / 1e6, 3),
        "flops": f"{total_flops:.3g}",
        "peak_mem_MB": round(max(l.memory_bytes for l in logs) / 1e6, 2),
        # virtual rounds are sub-millisecond at toy budgets: keep
        # significant digits, not fixed decimals, or the time axis
        # quantizes to nothing
        "sim_time_s": float(f"{logs[-1].sim_time_s:.4g}"),
        "dropped_total": sum(l.n_dropped for l in logs),
        "wall_s": round(wall_s, 1),
    }


def rounds_to_target(logs, target_loss: float) -> Optional[int]:
    for l in logs:
        if l.eval_loss <= target_loss:
            return l.round + 1
    return None


def time_to_target(logs, target_loss: float) -> Optional[float]:
    """Virtual seconds until eval loss first reaches ``target_loss`` —
    the time-to-accuracy axis (``RoundLog.sim_time_s`` is cumulative)."""
    for l in logs:
        if l.eval_loss <= target_loss:
            return l.sim_time_s
    return None


@dataclasses.dataclass
class RunResult:
    spec: ExperimentSpec
    logs: List[RoundLog]
    wall_s: float
    metrics: Dict[str, Any]
    pretrain_loss: Optional[float] = None
    # final global adapter tree — in-memory only, never serialized
    final_lora: Any = dataclasses.field(default=None, repr=False,
                                        compare=False)
    # serving export (run_experiment(..., export_adapters=True)):
    # an AdapterRegistry of the global + per-client personalized
    # adapters — in-memory only, never serialized
    adapter_registry: Any = dataclasses.field(default=None, repr=False,
                                              compare=False)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "schema": SCHEMA_VERSION,
            "spec": self.spec.to_dict(),
            "spec_hash": self.spec.spec_hash(),
            "wall_s": self.wall_s,
            "metrics": self.metrics,
            "pretrain_loss": self.pretrain_loss,
            "logs": [dataclasses.asdict(l) for l in self.logs],
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "RunResult":
        schema = d.get("schema", SCHEMA_VERSION)
        if schema != SCHEMA_VERSION:
            raise ValueError(f"unsupported result schema {schema!r}")
        return cls(spec=ExperimentSpec.from_dict(d["spec"]),
                   logs=[RoundLog(**l) for l in d["logs"]],
                   wall_s=d["wall_s"], metrics=d["metrics"],
                   pretrain_loss=d.get("pretrain_loss"))

    def save(self, path: str) -> str:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=1)
        return path

    @classmethod
    def load(cls, path: str) -> "RunResult":
        with open(path) as f:
            return cls.from_dict(json.load(f))
