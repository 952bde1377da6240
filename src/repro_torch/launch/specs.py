"""Stand-ins for every model input and state on the ``meta`` device (the
JAX package's ``ShapeDtypeStruct`` specs): the leaf names, shapes and
dtypes of the real trees, with no storage, so the dry-run can run a step
at production scale without allocating it.

The parameters and adapters are built by the real ``init_params`` /
``init_lora`` through a generator whose ``device`` is ``meta``: every
draw makes a meta tensor and advances nothing, and a real initialisation
draws exactly what it drew before.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import init_adamw

META = torch.device("meta")


class _MetaGenerator(torch.Generator):
    """A CPU generator that reports the ``meta`` device, so the init
    functions (which allocate on ``gen.device``) build meta trees."""

    @property
    def device(self) -> torch.device:
        return META


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def param_specs(cfg: ModelConfig, dtype=None):
    return T.init_params(cfg, _MetaGenerator(), dtype or _dtype(cfg.dtype))


def lora_specs(cfg: ModelConfig, rank: int = 32):
    return T.init_lora(cfg, _MetaGenerator(), rank=rank)


def opt_specs(lora_tree):
    return init_adamw(lora_tree)


def batch_specs(cfg: ModelConfig, shape: InputShape, *, with_labels: bool
                ) -> Dict[str, torch.Tensor]:
    b, s = shape.global_batch, shape.seq_len
    dtype = _dtype(cfg.dtype)
    out: Dict[str, torch.Tensor] = {}
    s_text = s
    if cfg.frontend == "vision":
        s_text = s - cfg.n_frontend_tokens
        out["vision_embeds"] = torch.empty(
            (b, cfg.n_frontend_tokens, cfg.d_model), dtype=dtype, device=META)
    if cfg.frontend == "audio":
        out["audio_embeds"] = torch.empty(
            (b, cfg.n_frontend_tokens, cfg.d_model), dtype=dtype, device=META)
    out["tokens"] = torch.empty((b, s_text), dtype=torch.int32, device=META)
    if with_labels:
        out["labels"] = torch.empty((b, s_text), dtype=torch.int32,
                                    device=META)
    return out


def cache_capacity(cfg: ModelConfig, shape: InputShape) -> int:
    """The decode cache's capacity: seq_len, or the sliding window for
    full-attention archs on long_500k (``effective_window``)."""
    window = cfg.effective_window(shape)
    return min(shape.seq_len, window) if window else shape.seq_len


def cache_specs(cfg: ModelConfig, shape: InputShape):
    """Decode-shape KV/SSM cache at ``cache_capacity``."""
    return T.init_cache(cfg, shape.global_batch, cache_capacity(cfg, shape),
                        _dtype(cfg.dtype), device=META)


def token_specs(shape: InputShape) -> torch.Tensor:
    return torch.empty((shape.global_batch, 1), dtype=torch.int32,
                       device=META)
