"""Qwen2-7B — dense GQA decoder with QKV bias. [arXiv:2407.10671]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen2-7b",
    family="dense",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18944,
    vocab=152064,
    head_dim=128,
    qkv_bias=True,
    rope_theta=1e6,
    source="arXiv:2407.10671 (Qwen2 technical report)",
)
