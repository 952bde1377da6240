"""Model configuration dataclasses.

Pure data, field for field the same as the JAX package's configs, so a
config (or a spec written by the JAX package) describes the same model
in both; the assigned input shapes are the same four. ``kernel_backend`` keeps its three values; in this package
``"pallas"`` names the hand-written Hopper kernels
(``repro_torch.kernels.dispatch``). There is no ``cache_key``: PyTorch
runs eagerly and has no compiled-program cache to key.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}

# Sliding-window length used by full-attention archs for long_500k decode.
LONG_CONTEXT_WINDOW = 4_096


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
    """The JAX package's fields, then the port's own (defaults keep the
    JAX package's rules: a softmax router, a Switch loss, every routed
    expert held here, slots dropped past ``capacity_factor``).

    DeepSeek-V3's published rules switch on with ``scoring="sigmoid"``:
    scores sigmoid(x W_r); selection on the scores plus the frozen
    per-expert ``e_score_correction_bias``; the ``n_group`` groups of
    experts ranked by the sum of their 2 best biased scores, the
    ``topk_group`` best kept, top ``top_k`` inside them; weights the
    unbiased scores normalised to sum 1, times ``routed_scale``; the
    sequence-wise balance loss (coefficient ``router_aux_coef``) in place
    of the Switch loss; and no drops (each held expert's buffer has a row
    for every token). ``n_routed`` is the router's width over all
    experts, of which this layer holds the ``n_experts`` from
    ``first_expert`` on (an expert share)."""

    n_experts: int = 0
    top_k: int = 2
    d_ff_expert: int = 0
    n_shared_experts: int = 0       # DeepSeek shared expert(s)
    first_dense_layers: int = 0     # DeepSeek: first k layers use dense MLP
    every: int = 1                  # jamba: MoE every `every`-th layer
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.001
    # the port's own
    scoring: str = "softmax"        # softmax | sigmoid
    n_group: int = 1
    topk_group: int = 1
    routed_scale: float = 1.0
    n_routed: int = 0               # router width; 0 -> n_experts
    first_expert: int = 0           # the first expert held here

    @property
    def router_width(self) -> int:
        return self.n_routed or self.n_experts


@dataclasses.dataclass(frozen=True)
class RopeScaling:
    """YaRN (arXiv:2309.00071) as DeepSeek-V3's ``rope_scaling`` states
    it: the rotary frequencies blended between the original and the
    original over ``factor`` along a linear ramp between the correction
    dims of ``beta_fast`` and ``beta_slow`` rotations at
    ``original_max_position_embeddings``; the tables times
    mscale(mscale) / mscale(mscale_all_dim) and the softmax scale times
    mscale(mscale_all_dim)², mscale(m) = 0.1 m ln(factor) + 1."""

    type: str = "yarn"
    factor: float = 1.0
    original_max_position_embeddings: int = 4096
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 1.0
    mscale_all_dim: float = 0.0


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
    rope_scaling: Optional[RopeScaling] = None   # the port's own (YaRN)
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

    def supports_shape(self, shape: InputShape) -> bool:
        """All assigned archs support all 4 shapes (long_500k via sliding
        window for full-attention families; native for ssm/hybrid)."""
        if shape.kind == "decode" and self.family == "encoder_only":
            return False  # (no encoder-only archs assigned)
        return True

    def effective_window(self, shape: InputShape) -> Optional[int]:
        """Attention window to use for a given input shape.

        ``long_500k`` on full-attention archs switches to a sliding window
        (sub-quadratic requirement); SSM archs have no attention at all and
        hybrids use the window for their sparse attention layers too.
        """
        if self.sliding_window is not None:
            return self.sliding_window
        if shape.name == "long_500k" and self.attn_kind != "none":
            return LONG_CONTEXT_WINDOW
        return None


#: the port's own fields, by dataclass, and the value that keeps the JAX
#: package's rules
PORT_ONLY = {
    "ModelConfig": {"rope_scaling": None},
    "MoEConfig": {f.name: f.default for f in dataclasses.fields(MoEConfig)
                  if f.name in ("scoring", "n_group", "topk_group",
                                "routed_scale", "n_routed", "first_expert")},
}


def shared_fields(cfg) -> dict:
    """``dataclasses.asdict(cfg)`` without the port's own fields where they
    keep the JAX package's rules: the dict a JAX package config of the
    same model gives. A port-only field that is set stays in, so the
    dicts then differ."""
    def strip(obj):
        if not dataclasses.is_dataclass(obj):
            return obj
        own = PORT_ONLY.get(type(obj).__name__, {})
        return {f.name: strip(getattr(obj, f.name))
                for f in dataclasses.fields(obj)
                if f.name not in own or getattr(obj, f.name) != own[f.name]}
    return strip(cfg)


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
