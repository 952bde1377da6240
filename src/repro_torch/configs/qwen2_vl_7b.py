"""Qwen2-VL-7B language backbone — M-RoPE, vision-embed frontend stub.

The ViT encoder + projector is a STUB per the assignment: ``input_specs``
feeds precomputed patch embeddings of shape (B, n_patches, d_model).
[arXiv:2409.12191]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen2-vl-7b",
    family="vlm",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18944,
    vocab=152064,
    head_dim=128,
    qkv_bias=True,
    rope_theta=1e6,
    frontend="vision",
    n_frontend_tokens=256,   # dynamic-resolution stub: 16x16 patch grid
    mrope=True,
    mrope_sections=(16, 24, 24),
    source="arXiv:2409.12191 (Qwen2-VL)",
)
