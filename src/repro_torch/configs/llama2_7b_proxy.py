"""LLaMA2-7B — the paper's own experimental subject. [arXiv:2307.09288]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="llama2-7b-proxy",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=11008,
    vocab=32000,
    head_dim=128,
    rope_theta=1e4,
    source="arXiv:2307.09288 (LLaMA 2)",
)
