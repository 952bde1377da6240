from repro_torch.lora.lora import (  # noqa: F401
    is_lora_a,
    is_lora_b,
    lora_bytes,
    lora_leaf_role,
    lora_param_count,
    merge_lora,
)
