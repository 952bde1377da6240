"""Architecture registry (the same 11 configs as the JAX package).

Each architecture has its own module defining ``CONFIG``; the registry
maps ``--arch <id>`` to it. ``llama2-7b-proxy`` is the paper's own
experimental subject (LLaMA2-7B).
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401
    INPUT_SHAPES,
    LONG_CONTEXT_WINDOW,
    InputShape,
    MLAConfig,
    MambaConfig,
    ModelConfig,
    MoEConfig,
    ReducedSpec,
    RopeScaling,
    pad_vocab,
    reduce_config,
    shared_fields,
)

_ARCH_MODULES = {
    "qwen2-vl-7b": "qwen2_vl_7b",
    "minicpm-2b": "minicpm_2b",
    "jamba-v0.1-52b": "jamba_v01_52b",
    "qwen3-32b": "qwen3_32b",
    "mamba2-2.7b": "mamba2_27b",
    "phi4-mini-3.8b": "phi4_mini_38b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "whisper-tiny": "whisper_tiny",
    "qwen2-7b": "qwen2_7b",
    "llama2-7b-proxy": "llama2_7b_proxy",
}

ARCH_IDS = [a for a in _ARCH_MODULES if a != "llama2-7b-proxy"]
ALL_ARCH_IDS = list(_ARCH_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(
        f"repro_torch.configs.{_ARCH_MODULES[arch_id]}")
    return mod.CONFIG



def get_shape(name: str) -> InputShape:
    return INPUT_SHAPES[name]
