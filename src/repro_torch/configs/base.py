"""Model configuration dataclasses.

Pure data, field for field the same as the JAX package's configs, so a
config (or a spec written by the JAX package) describes the same model
in both. ``kernel_backend`` keeps its three values; in this package
``"pallas"`` names the hand-written Hopper kernels
(``repro_torch.kernels.dispatch``). There is no ``cache_key``: PyTorch
runs eagerly and has no compiled-program cache to key.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


def pad_vocab(v: int, multiple: int = 128) -> int:
    """Pad the vocab to a multiple of 128 (embedding / lm_head rows)."""
    return ((v + multiple - 1) // multiple) * multiple


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-style Multi-head Latent Attention."""

    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_rope_head_dim: int = 64
    qk_nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0
    top_k: int = 2
    d_ff_expert: int = 0
    n_shared_experts: int = 0       # DeepSeek shared expert(s)
    first_dense_layers: int = 0     # DeepSeek: first k layers use dense MLP
    every: int = 1                  # jamba: MoE every `every`-th layer
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.001


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_state: int = 128
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    conv_width: int = 4
    chunk: int = 256


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0               # 0 -> d_model // n_heads
    # attention flavour
    attn_kind: str = "gqa"          # gqa | mla | none
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 1e6
    sliding_window: Optional[int] = None   # static window (if arch has one)
    mla: Optional[MLAConfig] = None
    # mlp / moe
    moe: Optional[MoEConfig] = None
    # ssm / hybrid
    mamba: Optional[MambaConfig] = None
    attn_period: int = 0            # hybrid: 1 attn layer per period
    attn_offset: int = 0            # position of attn layer inside period
    # multimodal frontends (stubs per the assignment)
    frontend: Optional[str] = None  # "vision" | "audio"
    n_frontend_tokens: int = 0      # patches / audio frames
    mrope: bool = False
    mrope_sections: Tuple[int, ...] = (16, 24, 24)  # qwen2-vl t/h/w freq split
    # enc-dec
    is_encdec: bool = False
    n_enc_layers: int = 0
    # misc
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # kernel backend for the model hot path: "pallas" (the Hopper
    # kernels) | "reference" | "auto" — repro_torch.kernels.dispatch
    kernel_backend: str = "auto"
    # source citation (paper / model card)
    source: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def padded_vocab(self) -> int:
        return pad_vocab(self.vocab)

    def layer_stacks(self):
        """Names + sizes of homogeneous layer stacks (DEVFT operates per stack).

        Returns list of (stack_name, n_layers_in_stack).
        """
        if self.family == "hybrid":
            n_attn = self.n_layers // self.attn_period
            n_mamba = self.n_layers - n_attn
            every = self.moe.every if self.moe else 1
            n_moe_layers = self.n_layers // every if self.moe else 0
            # attn layers sit at even indices (offset 4, period 8) -> dense MLP
            n_mamba_moe = n_moe_layers
            n_mamba_mlp = n_mamba - n_mamba_moe
            return [
                ("mamba_mlp", n_mamba_mlp),
                ("mamba_moe", n_mamba_moe),
                ("attn_mlp", n_attn),
            ]
        if self.is_encdec:
            return [("enc", self.n_enc_layers), ("dec", self.n_layers)]
        if self.moe and self.moe.first_dense_layers:
            return [
                ("dense", self.moe.first_dense_layers),
                ("moe", self.n_layers - self.moe.first_dense_layers),
            ]
        return [("layers", self.n_layers)]


@dataclasses.dataclass(frozen=True)
class ReducedSpec:
    """How to shrink a config for CPU smoke tests."""

    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 2
    d_ff: int = 512
    vocab: int = 512
    n_experts: int = 4
    top_k: int = 2


def reduce_config(cfg: ModelConfig, spec: ReducedSpec = ReducedSpec()) -> ModelConfig:
    """Build the reduced same-family variant used by smoke tests.

    Keeps every structural flag (GQA vs MLA, qk_norm, bias, MoE, hybrid
    interleave, enc-dec, frontend) while shrinking all dimensions.
    """
    kw = {}
    kw["n_layers"] = max(spec.n_layers, cfg.attn_period or 0)
    if cfg.family == "hybrid":
        # keep one full interleave period
        kw["n_layers"] = cfg.attn_period
        kw["attn_period"] = cfg.attn_period
    kw["d_model"] = spec.d_model
    kw["n_heads"] = spec.n_heads
    kw["n_kv_heads"] = min(spec.n_kv_heads, spec.n_heads) if cfg.n_kv_heads else 0
    if cfg.n_kv_heads == cfg.n_heads:  # MHA archs stay MHA
        kw["n_kv_heads"] = spec.n_heads
    kw["d_ff"] = spec.d_ff
    kw["vocab"] = spec.vocab
    kw["head_dim"] = spec.d_model // spec.n_heads
    if cfg.mla is not None:
        kw["mla"] = MLAConfig(
            q_lora_rank=64, kv_lora_rank=32, qk_rope_head_dim=16,
            qk_nope_head_dim=32, v_head_dim=32,
        )
        kw["head_dim"] = 0
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe,
            n_experts=min(spec.n_experts, cfg.moe.n_experts),
            top_k=min(spec.top_k, cfg.moe.top_k),
            d_ff_expert=spec.d_ff // 2 if cfg.moe.d_ff_expert else 0,
            first_dense_layers=1 if cfg.moe.first_dense_layers else 0,
        )
        if cfg.moe.first_dense_layers:
            kw["n_layers"] = 3  # 1 dense + 2 moe
    if cfg.mamba is not None:
        kw["mamba"] = dataclasses.replace(
            cfg.mamba, d_state=16, head_dim=32, chunk=32,
        )
    if cfg.is_encdec:
        kw["n_enc_layers"] = 2
    if cfg.frontend:
        kw["n_frontend_tokens"] = 8
    if cfg.mrope:
        # rescale section split to the reduced head_dim (keep 1:1.5:1.5)
        half = (kw.get("head_dim") or spec.d_model // spec.n_heads) // 2
        s0 = half // 4
        kw["mrope_sections"] = (s0, (half - s0) // 2,
                                half - s0 - (half - s0) // 2)
    return dataclasses.replace(cfg, **kw)
