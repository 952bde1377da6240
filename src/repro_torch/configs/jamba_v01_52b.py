"""Jamba-v0.1 (52B) — hybrid Mamba+attention 1:7 interleave with MoE.

32 layers; 1 attention layer per 8 (offset 4); MoE (16 experts, top-2)
every 2nd layer. [arXiv:2403.19887]
"""
from repro_torch.configs.base import MambaConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=65536,
    head_dim=128,
    rope_theta=1e4,
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=14336, every=2),
    mamba=MambaConfig(d_state=16, expand=2, head_dim=64, n_groups=1,
                      conv_width=4, chunk=256),
    attn_period=8,
    attn_offset=4,
    source="arXiv:2403.19887 (Jamba)",
)
