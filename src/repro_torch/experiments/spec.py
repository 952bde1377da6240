"""ExperimentSpec — the one serializable description of a run (the JAX
package's ``repro.experiments.spec``: the same fields, defaults, JSON
schema and ``spec_hash``, so a spec written by either package runs in
the other).

A spec composes everything needed to reproduce an experiment:

* **model** — ``arch`` (registry id), ``full`` (cluster-scale config vs
  reduced), ``reduced`` (ReducedSpec field overrides), ``layers`` (depth
  override for reduced runs);
* **data** — ``n_clients``, ``alpha`` (Dirichlet non-IID), ``noise``,
  ``seed`` (shared by data generation and the federated engine);
* **federated** — every knob in :class:`repro_torch.federated.FedConfig`,
  field-for-field (including ``lr_stage_factor`` and ``flora_ranks``,
  which no CLI exposed before);
* **execution** — ``mesh`` (``None``/"none", "host" or "production";
  the port runs on one device and its runner raises for a mesh).
  Trajectories are mesh-independent, so this knob is excluded from
  ``base_key()``;
* **budget / pretrain** — ``pretrain_steps`` + ``homogeneous_init``
  (the structured-base protocol of DESIGN.md §7).

The spec is frozen, JSON-round-trippable (``to_dict``/``from_dict``,
``to_json``/``from_json``, ``save``/``load``) and hashable by content
(``spec_hash``). The federated defaults here mirror ``FedConfig``
exactly, so there is a single source of defaults.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, Dict, Optional, Tuple

from repro_torch.configs import get_config, reduce_config
from repro_torch.configs.base import ReducedSpec
from repro_torch.federated.simulator import FedConfig

SCHEMA_VERSION = 1

# FedConfig fields the spec mirrors 1:1 (same names, same defaults).
FED_FIELDS = tuple(f.name for f in dataclasses.fields(FedConfig))

_REDUCED_KEYS = frozenset(f.name for f in dataclasses.fields(ReducedSpec))


@dataclasses.dataclass(frozen=True)
class ExperimentSpec:
    # ---- model -------------------------------------------------------
    arch: str = "llama2-7b-proxy"
    full: bool = False                       # cluster-scale config
    layers: Optional[int] = None             # depth override (reduced)
    reduced: Optional[Dict[str, int]] = None  # ReducedSpec overrides
    kernel_backend: str = "auto"             # pallas | reference | auto
    # ---- data --------------------------------------------------------
    alpha: float = 0.5                       # Dirichlet concentration
    noise: float = 0.05                      # label-noise fraction
    # ---- federated (mirrors FedConfig; single source of defaults) ---
    n_clients: int = 20
    sample_frac: float = 0.1
    k_local: int = 10
    local_batch: int = 16
    seq: int = 64
    rounds: int = 30
    lora_rank: int = 32
    lr: float = 1e-4
    method: str = "fedit"
    eval_every: int = 1
    population: str = "uniform"          # device fleet (heterogeneity)
    straggler_policy: str = "accept-partial"
    weighting: str = "uniform"           # uniform | examples | fednova
    deadline_factor: float = 2.0
    n_stages: int = 4
    growth: float = 2.0
    initial_capacity: Optional[int] = None
    beta: float = 0.1
    grouping: str = "dglg"
    fusion: str = "dblf"
    lr_stage_factor: float = 10.0
    flora_ranks: Optional[Tuple[int, ...]] = None
    aggregation: Optional[str] = None
    seed: int = 0
    # ---- execution ---------------------------------------------------
    # mesh the round engine runs on: None/"none" (default device),
    # "host" (1x1 CPU-test mesh) or "production" (single-pod 16x16).
    # Trajectories are mesh-independent, so this is an execution knob,
    # not part of base_key().
    mesh: Optional[str] = None
    # ---- budget / pretrain ------------------------------------------
    pretrain_steps: int = 0                  # 0 -> random init
    homogeneous_init: bool = True            # identical-layer init

    def __hash__(self):
        # the auto-generated frozen hash chokes on the `reduced` dict;
        # hash by content instead (consistent with __eq__ via to_dict)
        return hash(self.spec_hash())

    def __post_init__(self):
        from repro_torch.kernels.dispatch import canonical
        canonical(self.kernel_backend)       # raises on unknown backend
        if self.mesh is not None and self.mesh not in ("none", "host",
                                                       "production"):
            raise ValueError(f"unknown mesh {self.mesh!r}; known: "
                             f"none, host, production")
        if self.eval_every < 1:
            raise ValueError(f"eval_every must be >= 1, got "
                             f"{self.eval_every}")
        from repro_torch.federated.heterogeneity import (POLICIES,
                                                         WEIGHTINGS,
                                                   available_fleets)
        if self.population not in available_fleets():
            raise ValueError(f"unknown population {self.population!r}; "
                             f"available: {available_fleets()}")
        if self.straggler_policy not in POLICIES:
            raise ValueError(f"unknown straggler_policy "
                             f"{self.straggler_policy!r}; available: "
                             f"{list(POLICIES)}")
        if self.weighting not in WEIGHTINGS:
            raise ValueError(f"unknown weighting {self.weighting!r}; "
                             f"available: {list(WEIGHTINGS)}")
        if self.deadline_factor <= 0:
            raise ValueError(f"deadline_factor must be > 0, got "
                             f"{self.deadline_factor}")
        if self.flora_ranks is not None:
            object.__setattr__(self, "flora_ranks",
                               tuple(int(r) for r in self.flora_ranks))
        if self.reduced is not None:
            bad = set(self.reduced) - _REDUCED_KEYS
            if bad:
                raise ValueError(
                    f"unknown ReducedSpec override(s) {sorted(bad)}; "
                    f"known: {sorted(_REDUCED_KEYS)}")
            object.__setattr__(self, "reduced", dict(self.reduced))

    # ---- serialization ----------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        if d["flora_ranks"] is not None:
            d["flora_ranks"] = list(d["flora_ranks"])
        d["schema"] = SCHEMA_VERSION
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ExperimentSpec":
        d = dict(d)
        schema = d.pop("schema", SCHEMA_VERSION)
        if schema != SCHEMA_VERSION:
            raise ValueError(f"unsupported spec schema {schema!r} "
                             f"(this build reads {SCHEMA_VERSION})")
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown ExperimentSpec field(s) "
                             f"{sorted(unknown)}")
        return cls(**d)

    def to_json(self, indent: Optional[int] = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "ExperimentSpec":
        return cls.from_dict(json.loads(s))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json() + "\n")

    @classmethod
    def load(cls, path: str) -> "ExperimentSpec":
        with open(path) as f:
            return cls.from_json(f.read())

    def replace(self, **kw) -> "ExperimentSpec":
        return dataclasses.replace(self, **kw)

    # ---- hashing -----------------------------------------------------
    def spec_hash(self) -> str:
        """Content hash of the full spec (cache keys, artifact names)."""
        return _digest(self.to_dict())

    def base_key(self, device="cpu") -> str:
        """Hash of the spec projection that determines the pretrained
        base: model shape + pretrain protocol + seed + the backend that
        resolves on ``device``. Derived from the full spec, so two specs
        differing in ``reduced["vocab"]`` or ``seq`` get different bases,
        while specs differing only in method/rounds/... share one. On
        the CPU it equals the JAX package's ``base_key()`` there."""
        return _digest({
            "arch": self.arch, "full": self.full, "layers": self.layers,
            "reduced": self.reduced, "seq": self.seq,
            "n_clients": self.n_clients,
            "pretrain_steps": self.pretrain_steps,
            "homogeneous_init": self.homogeneous_init, "seed": self.seed,
            # the *resolved* backend changes pretraining numerics on
            # the card; resolving first lets e.g. "auto" and
            # "reference" share one base on the CPU
            "kernel_backend": _resolve_backend(self.kernel_backend, device),
        })

    # ---- materialization --------------------------------------------
    def fed_config(self) -> FedConfig:
        return FedConfig(**{f: getattr(self, f) for f in FED_FIELDS})

    def build_cfg(self):
        """Model config for this spec (reduce unless ``full``, then apply
        the depth override). The spec's ``kernel_backend`` rides on the
        config so every layer — including DEVFT submodels built from it
        by ``dataclasses.replace`` — dispatches consistently."""
        cfg = get_config(self.arch)
        if not self.full:
            rspec = ReducedSpec(**self.reduced) if self.reduced \
                else ReducedSpec()
            cfg = reduce_config(cfg, rspec)
            if self.layers:
                cfg = dataclasses.replace(cfg, n_layers=self.layers)
        return dataclasses.replace(cfg, kernel_backend=self.kernel_backend)


def _digest(obj) -> str:
    blob = json.dumps(obj, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()[:12]


def _resolve_backend(backend: str, device) -> str:
    from repro_torch.kernels.dispatch import resolve
    return resolve(backend, device)
