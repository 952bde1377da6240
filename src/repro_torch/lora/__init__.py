from repro_torch.lora.lora import (  # noqa: F401
    lora_bytes,
    lora_leaf_role,
    lora_param_count,
    merge_lora,
)
