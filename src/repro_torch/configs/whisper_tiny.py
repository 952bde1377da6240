"""Whisper-tiny backbone — encoder-decoder transformer.

The mel-spectrogram + conv frontend is a STUB per the assignment:
``input_specs`` feeds precomputed frame embeddings (B, 1500, d_model)
to the encoder. Decode shapes exercise the decoder self-attn cache at
the assigned lengths (real whisper caps at 448 — noted in DESIGN.md).
[arXiv:2212.04356]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="whisper-tiny",
    family="audio",
    n_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab=51865,
    head_dim=64,
    rope_theta=1e4,
    is_encdec=True,
    n_enc_layers=4,
    frontend="audio",
    n_frontend_tokens=1500,
    source="arXiv:2212.04356 (Whisper)",
)
