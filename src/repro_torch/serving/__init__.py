"""Multi-tenant LoRA serving: continuous batching, per-request
adapters, ragged KV cache."""
from repro_torch.serving.adapters import (
    AdapterRegistry,
    personalized_adapters,
    registry_from_run,
)
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.kv_cache import KVCacheManager, check_capacity, flash_decode
from repro_torch.serving.scheduler import Request, RequestState, SlotScheduler

__all__ = [
    "AdapterRegistry",
    "KVCacheManager",
    "Request",
    "RequestState",
    "ServingEngine",
    "SlotScheduler",
    "check_capacity",
    "flash_decode",
    "personalized_adapters",
    "registry_from_run",
]
