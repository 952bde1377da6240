"""The tuning cache's read side: the JSON store of tuned plan knobs, its
keys (the card's name, a hash of each kernel's sources, the call's
shapes) and where it lives. ``dispatch`` reads it; the autotuner
(``repro_torch.kernels.autotune``) fills it.

The cache is keyed on the card's name (``torch.cuda.get_device_name``)
and, per kernel, on a hash of its ``.cu`` source and its wrapper module;
a changed hash drops the kernel's bucket.
"""
from __future__ import annotations

import dataclasses
import hashlib
import importlib
import json
import os
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import torch

#: env var naming the cache file; ``dispatch`` reads a cache only when
#: this names one or ``dispatch.set_tuning_cache`` installed one
CACHE_ENV = "REPRO_TORCH_TUNING_CACHE"


@dataclasses.dataclass(frozen=True)
class TunedKernel:
    module: str                 # the wrapper, repro_torch.kernels.<module>
    source: str                 # csrc/<source>.cu
    key_kwargs: Tuple[str, ...]  # keyword arguments that enter the key


#: the kernels whose plans take tuned knobs (``ssd_scan`` is not one: its
#: chunk changes the numerics, not only the schedule)
KERNELS: Dict[str, TunedKernel] = {
    "lora_matmul": TunedKernel("lora_matmul", "lora_matmul", ()),
    "moe_expert_ffn": TunedKernel("moe_ffn", "moe_ffn", ()),
    "flash_attention": TunedKernel("flash_attention", "flash_attention",
                                   ("causal", "window")),
    "flash_decode": TunedKernel("flash_decode", "flash_decode", ()),
}


def module(name: str):
    """The wrapper module of tunable kernel ``name``."""
    return importlib.import_module(
        f"repro_torch.kernels.{KERNELS[name].module}")


def default_cache_path() -> str:
    """``$REPRO_TORCH_TUNING_CACHE``, else ``build/repro_torch/tuning.json``
    in the checkout."""
    env = os.environ.get(CACHE_ENV)
    if env:
        return env
    from repro_torch.kernels.build import BUILD_DIR
    return str(BUILD_DIR / "tuning.json")


def source_hash(name: str) -> str:
    """The staleness key of kernel ``name``'s bucket: a hash of its
    ``.cu`` source and its wrapper module."""
    mod = module(name)
    csrc = Path(mod.__file__).resolve().parent / "csrc"
    h = hashlib.sha256()
    h.update((csrc / f"{KERNELS[name].source}.cu").read_bytes())
    h.update(Path(mod.__file__).read_bytes())
    return h.hexdigest()[:16]


def shape_key(name: str, args: Sequence, kwargs: Optional[Dict] = None
              ) -> str:
    """Canonical key of one call: the positional operands' shapes and
    dtypes, and the keyword arguments that change the plan's work."""
    parts = ["x".join(str(d) for d in a.shape) + ":"
             + str(a.dtype).replace("torch.", "")
             for a in args if isinstance(a, torch.Tensor)]
    kwargs = kwargs or {}
    parts += [f"{k}={kwargs.get(k)}" for k in KERNELS[name].key_kwargs]
    return "|".join(parts)


@dataclasses.dataclass
class TuningCache:
    """Device-keyed winner store::

        {device name: {kernel: {"source_hash": str,
                                "entries": {shape_key: {"config": {...},
                                                        "us": float,
                                                        "default_us": float}}}}}
    """

    path: str
    data: Dict = dataclasses.field(default_factory=dict)

    @classmethod
    def load(cls, path: Optional[str] = None) -> "TuningCache":
        path = path or default_cache_path()
        data: Dict = {}
        if os.path.exists(path):
            try:
                with open(path) as f:
                    data = json.load(f)
            except (json.JSONDecodeError, OSError):
                data = {}        # a corrupt cache is a miss, never a crash
            if not isinstance(data, dict):
                data = {}
        return cls(path=path, data=data)

    def save(self) -> str:
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        with open(self.path, "w") as f:
            json.dump(self.data, f, indent=1, sort_keys=True)
            f.write("\n")
        return self.path

    def has_device(self, device: str) -> bool:
        return bool(self.data.get(device))

    def lookup(self, device: str, kernel: str, key: str,
               src_hash: str) -> Optional[Dict[str, int]]:
        """The tuned knobs for one (device, kernel, shape), or None on a
        miss or a stale ``src_hash`` (the plan's own knobs then)."""
        bucket = self.data.get(device, {}).get(kernel)
        if not bucket or bucket.get("source_hash") != src_hash:
            return None
        entry = bucket.get("entries", {}).get(key)
        return dict(entry["config"]) if entry else None

    def store(self, device: str, kernel: str, src_hash: str, key: str,
              config: Dict[str, int], us: float, default_us: float) -> None:
        bucket = self.data.setdefault(device, {}).setdefault(
            kernel, {"source_hash": src_hash, "entries": {}})
        if bucket.get("source_hash") != src_hash:
            # the kernel or its wrapper changed: no old entry is valid
            bucket["source_hash"] = src_hash
            bucket["entries"] = {}
        bucket["entries"][key] = {"config": dict(config), "us": float(us),
                                  "default_us": float(default_us)}
