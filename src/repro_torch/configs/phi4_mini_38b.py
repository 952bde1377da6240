"""Phi-4-mini (3.8B) — dense GQA, RoPE + SwiGLU. [arXiv:2412.08905]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="phi4-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab=200064,
    head_dim=128,
    rope_theta=1e4,
    source="arXiv:2412.08905 (Phi-4 family)",
)
