"""Granite-3.0-1B-A400M — 32-expert top-8 MoE, tied embeddings.
[hf:ibm-granite/granite-3.0-1b-a400m-base]"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,
    vocab=49155,
    head_dim=64,
    moe=MoEConfig(n_experts=32, top_k=8, d_ff_expert=512),
    rope_theta=1e4,
    tie_embeddings=True,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)
