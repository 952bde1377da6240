"""DeepSeek-V3 (671B) — MLA attention + fine-grained MoE.

61 layers (first 3 dense d_ff=18432); 58 MoE layers with 256 routed
experts (top-8, d_ff=2048 per the assignment) + 1 shared expert.
MTP (multi-token prediction) heads exposed via model option.
[arXiv:2412.19437]

This registry config keeps the JAX package's rules, field for field
(``configs.shared_fields``): a softmax router with a Switch loss, every
routed expert held, slots dropped past a capacity of 1.25x, plain RoPE.
The published rules are the port's own fields, which a configuration
sets: ``MoEConfig`` ``scoring="sigmoid"`` (the grouped sigmoid router,
the sequence-wise balance loss and no drops) with ``n_group=8``,
``topk_group=4``, ``routed_scale=2.5`` and ``router_aux_coef=1e-4``,
and for an expert share ``n_routed=256`` with ``n_experts`` and
``first_expert`` the experts held; ``ModelConfig.rope_scaling`` YaRN
(factor 40, original length 4096, beta 32 / 1, mscale 1 / 1). The
benchmark's ``fedbench/configs/deepseek-v3-8l.json`` does so.
"""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=18432,             # dense-prefix MLP width
    vocab=129280,
    attn_kind="mla",
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512, qk_rope_head_dim=64,
                  qk_nope_head_dim=128, v_head_dim=128),
    moe=MoEConfig(n_experts=256, top_k=8, d_ff_expert=2048,
                  n_shared_experts=1, first_dense_layers=3),
    rope_theta=1e4,
    source="arXiv:2412.19437 (DeepSeek-V3)",
)
