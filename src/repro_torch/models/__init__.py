from repro_torch.models import layers, transformer  # noqa: F401
from repro_torch.models.transformer import (  # noqa: F401
    decode_step,
    init_cache,
    init_lora,
    init_params,
)
