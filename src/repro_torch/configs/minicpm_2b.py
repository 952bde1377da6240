"""MiniCPM-2B — llama-like dense (MHA), WSD LR schedule, tied embeddings.

WSD (warmup-stable-decay) is ported: ``repro_torch.optim.schedule.wsd``.
[arXiv:2404.06395]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="minicpm-2b",
    family="dense",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,
    d_ff=5760,
    vocab=122753,
    head_dim=64,
    rope_theta=1e4,
    tie_embeddings=True,
    source="arXiv:2404.06395 (MiniCPM)",
)
