"""Mamba2-2.7B — attention-free SSD (state-space duality). [arXiv:2405.21060]

d_inner = expand * d_model = 5120; heads = d_inner / head_dim = 80.
"""
from repro_torch.configs.base import MambaConfig, ModelConfig

CONFIG = ModelConfig(
    arch_id="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=50280,
    attn_kind="none",
    mamba=MambaConfig(d_state=128, expand=2, head_dim=64, n_groups=1,
                      conv_width=4, chunk=256),
    source="arXiv:2405.21060 (Mamba-2 / SSD)",
)
